"""Cross-validation of the trollbase-replacement geometry.

The Kabsch-Sander H-bond energy and the DSSP-lite assignment in
structure/geometry.py previously had no independent check — a sign or
cutoff error in the energy formula would have passed every suite
(absolute H-bond/SSE features have no reference oracle; trollbase is
absent).  Two implementation-independent ground truths are used:

1. IDEAL GEOMETRY: backbones built from textbook internal coordinates
   (NeRF chain extension with standard bond lengths/angles).  An ideal
   alpha helix (phi=-57, psi=-47) MUST produce the canonical
   N-H(i+4) -> O=C(i) bonds with energies near -2 to -3 kcal/mol for
   every interior residue, and DSSP-lite must call it one helix; an
   ideal antiparallel beta hairpin must produce inter-strand ladder
   bonds and strand assignments.  These facts come from the geometry of
   protein structure, not from any implementation.

2. An independently written, fully vectorized Kabsch-Sander energy
   (different code path: all-pairs matrices, H placed via the same
   published rule) compared bond-for-bond on the repo's real PDB
   fixtures.
"""

from __future__ import annotations

import os

import numpy as np

from alignment_algos_tpu.structure.geometry import (KS_CUTOFF, KS_Q1Q2F,
                                                    assign_sses_dssp,
                                                    backbone_hbonds)
from alignment_algos_tpu.structure.pdb import (Chain, HELIX_TYPE, Residue,
                                               STRAND_TYPE, parse_pdb_chain)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# standard backbone internal coordinates (Engh & Huber)
B_N_CA, B_CA_C, B_C_N, B_C_O = 1.458, 1.525, 1.329, 1.231
A_N_CA_C, A_CA_C_N, A_C_N_CA = 111.2, 116.2, 121.7
A_CA_C_O = 120.8


def _nerf(a, b, c, r, theta_deg, chi_deg):
    """Place atom D given chain A-B-C, bond |CD| = r, angle BCD = theta,
    dihedral ABCD = chi (natural extension reference frame)."""
    theta = np.radians(theta_deg)
    chi = np.radians(chi_deg)
    bc = c - b
    bc /= np.linalg.norm(bc)
    ab = b - a
    n = np.cross(ab, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    d2 = np.array([-r * np.cos(theta),
                   r * np.sin(theta) * np.cos(chi),
                   r * np.sin(theta) * np.sin(chi)])
    return c + d2[0] * bc + d2[1] * m + d2[2] * n


def _build_backbone(phi_psi, olc="A"):
    """Backbone (N, CA, C, O per residue) from a list of (phi, psi);
    omega fixed at 180.  Returns a Chain."""
    n_res = len(phi_psi)
    # seed residue: arbitrary frame
    N0 = np.array([0.0, 0.0, 0.0])
    CA0 = np.array([B_N_CA, 0.0, 0.0])
    C0 = _nerf(np.array([-1.0, 1.0, 0.0]), N0, CA0, B_CA_C, A_N_CA_C, 120.0)
    coords = [[N0, CA0, C0]]
    for i in range(1, n_res):
        phi_prev_psi = phi_psi[i - 1][1]
        N = _nerf(coords[i - 1][0], coords[i - 1][1], coords[i - 1][2],
                  B_C_N, A_CA_C_N, phi_prev_psi)          # psi_{i-1}
        CA = _nerf(coords[i - 1][1], coords[i - 1][2], N,
                   B_N_CA, A_C_N_CA, 180.0)               # omega
        C = _nerf(coords[i - 1][2], N, CA, B_CA_C, A_N_CA_C,
                  phi_psi[i][0])                          # phi_i
        coords.append([N, CA, C])
    chain = Chain("A")
    for i in range(n_res):
        N, CA, C = coords[i]
        atoms = {"N": N, "CA": CA, "C": C}
        if i + 1 < n_res:
            # O anti to the next N across the peptide plane
            Nn = coords[i + 1][0]
            co = _nerf(Nn, CA, C, B_C_O, A_CA_C_O, 180.0)
            atoms["O"] = co
        else:
            atoms["O"] = _nerf(N, CA, C, B_C_O, A_CA_C_O,
                               phi_psi[i][1] + 180.0)
        r = Residue(resseq=i + 1, icode="", name="ALA", olc=olc,
                    atoms=atoms,
                    elements={k: k[0] for k in atoms})
        chain.residues.append(r)
    return chain


def test_ideal_alpha_helix_hbonds_and_assignment():
    n = 16
    chain = _build_backbone([(-57.0, -47.0)] * n)
    hb = backbone_hbonds(chain)
    hbset = set(hb)
    # canonical alpha pattern: N-H of i+4 donates to C=O of i
    for i in range(1, n - 5):
        assert (i + 4, i) in hbset, \
            f"missing i+4->i helix H-bond at i={i}: {sorted(hbset)}"
    # energies must be clearly bonded (DSSP reports ~-2..-3 kcal/mol);
    # recompute one interior bond's energy directly
    N = chain.coords("N")
    C = chain.coords("C")
    O = chain.coords("O")
    i, j = 8, 4
    co = C[j - 0 - 1 + 1] - O[j]  # not used; energy check below
    co_prev = C[i - 1] - O[i - 1]
    H = N[i] + co_prev / np.linalg.norm(co_prev)
    e = KS_Q1Q2F * (1 / np.linalg.norm(O[j] - N[i])
                    + 1 / np.linalg.norm(C[j] - H)
                    - 1 / np.linalg.norm(O[j] - H)
                    - 1 / np.linalg.norm(C[j] - N[i]))
    assert -5.0 < e < -1.0, f"ideal helix bond energy implausible: {e}"
    sses = assign_sses_dssp(chain, hb)
    helix_res = set()
    for s in sses:
        if s.sse_type == HELIX_TYPE:
            helix_res.update(s.res_indices)
    assert len(helix_res) >= n - 6, f"helix under-assigned: {sorted(helix_res)}"
    assert not any(s.sse_type == STRAND_TYPE for s in sses)


def test_ideal_beta_hairpin_strands():
    # two antiparallel strands (phi=-139, psi=135) joined by a type-II'
    # beta turn — the canonical hairpin-closing turn
    n_str = 7
    pp = [(-139.0, 135.0)] * n_str + [(60.0, -120.0), (-80.0, 0.0)] \
        + [(-139.0, 135.0)] * n_str
    chain = _build_backbone(pp)
    hb = backbone_hbonds(chain)
    sses = assign_sses_dssp(chain, hb)
    strand_res = set()
    for s in sses:
        if s.sse_type == STRAND_TYPE:
            strand_res.update(s.res_indices)
    # at least a few residues of each strand must pair across the hairpin
    first = strand_res & set(range(0, n_str))
    second = strand_res & set(range(n_str + 2, 2 * n_str + 2))
    assert len(first) >= 2 and len(second) >= 2, \
        f"hairpin strands not detected: {sorted(strand_res)}; hb={sorted(hb)}"


def _hbonds_vectorized(chain):
    """Independent all-pairs Kabsch-Sander implementation (straight from
    the published formula, vectorized; shares no code with geometry.py's
    scalar loop)."""
    n = len(chain)
    N = chain.coords("N")
    C = chain.coords("C")
    O = chain.coords("O", fallback="C")
    H = N.copy()
    co = C[:-1] - O[:-1]
    nrm = np.linalg.norm(co, axis=1)
    ok = nrm > 1e-6
    H[1:][ok] = N[1:][ok] + co[ok] / nrm[ok][:, None]

    def pd(X, Y):
        return np.linalg.norm(X[:, None, :] - Y[None, :, :], axis=-1)

    r_on = pd(N, O)          # [donor i, acceptor j]
    r_ch = pd(H, C)
    r_oh = pd(H, O)
    r_cn = pd(N, C)
    with np.errstate(divide="ignore"):
        E = 0.084 * 332.0 * (1 / r_on + 1 / r_ch - 1 / r_oh - 1 / r_cn)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    valid = (np.abs(ii - jj) >= 2) & (ii != 0) & (r_on <= 5.2) \
        & (np.minimum(np.minimum(r_ch, r_oh), r_cn) >= 0.5)
    pro = np.array([r.olc == "P" for r in chain.residues])
    valid &= ~pro[:, None]
    bonded = valid & (E < -0.5)
    return {(int(i), int(j)) for i, j in zip(*np.nonzero(bonded))}


def test_hbonds_match_independent_impl_on_real_structures():
    for fn in ("test_struct.pdb", "real_struct.pdb", "big_struct.pdb"):
        path = os.path.join(DATA, fn)
        if not os.path.exists(path):
            continue
        chain = parse_pdb_chain(path)
        got = set(backbone_hbonds(chain))
        exp = _hbonds_vectorized(chain)
        assert got == exp, (f"{fn}: H-bond sets differ; only-loop="
                            f"{sorted(got - exp)[:5]} only-vec="
                            f"{sorted(exp - got)[:5]}")
