#!/usr/bin/env python3
"""Synthesize a (PDB, SMAP .prof, query .prof) fixture triple.

Builds an ideal-geometry backbone for a given secondary-structure string
(make_pdb.build_backbone), writes the PDB with HELIX/SHEET records, and a
matching SMAP profile (``PDB:`` header + per-residue profile/gap/SSE rows in
the hmapalib_seq.cpp:182-243 format) whose sequence and SSE probabilities
are consistent with the structure.  Used to generate larger SSSS parity
fixtures than the original 30-residue fold.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_pdb import build_backbone, write_pdb, write_pdb_real  # noqa: E402

AA = "ARNDCQEGHILKMFPSTWYV"


def _sse_ranges(ss: str, kind: str):
    out = []
    i = 0
    while i < len(ss):
        if ss[i] == kind:
            j = i
            while j < len(ss) and ss[j] == kind:
                j += 1
            out.append((i + 1, j))  # 1-based inclusive
            i = j
        else:
            i += 1
    return out


def profile_text(rng, name: str, seq: str, ss: str | None = None,
                 pdb_name: str = "", evd=(20.0, 6.0)) -> str:
    """SMAP (with pdb_name) or plain HMAP (without) profile text."""
    n = len(seq)
    lines = []
    if pdb_name:
        lines.append(f"PDB: {pdb_name} A")
    lines += [f"ID : {name}", "DE : synthetic", "SR : none",
              f"EVD: {evd[0]:g} {evd[1]:g}", f"LEN: {n}"]
    kind_of = {"H": 0, "E": 1, "C": 2}
    for i in range(1, n + 1):
        olc = seq[i - 1]
        prof = rng.dirichlet(np.ones(20) * 0.3) * 100.0
        prof *= 0.4
        prof[AA.index(olc)] += 60.0
        prof_s = " ".join(f"{v:.2f}" for v in prof)
        lines.append(f"{i:4d} {olc} {prof_s}")
        gi = float(rng.uniform(2.0, 6.0))
        ge = float(rng.uniform(0.1, 0.6))
        lines.append(f"   -   {gi:.3f} {ge:.3f} 0.000 0.000 "
                     f"{rng.uniform(0, 1):.3f} {rng.uniform(0, 1):.3f}")
        kind = (kind_of[ss[i - 1]] if ss is not None
                else int(rng.integers(0, 3)))
        base = rng.dirichlet(np.ones(3)) * 0.2
        base[kind] += 0.8
        base /= base.sum()
        conf = float(rng.uniform(0.6, 0.99))
        lines.append(f"   *   {base[0]:.3f} {base[1]:.3f} {base[2]:.3f} "
                     f"{conf:.3f} {rng.uniform(0, 1):.3f} "
                     f"{rng.uniform(0, 1):.3f}")
    lines.append("//")
    return "\n".join(lines) + "\n"


def make_fixture(out_dir: str, tag: str, ss: str, query_len: int,
                 seed: int = 0):
    rng = np.random.default_rng(seed)
    seq = "".join(AA[i] for i in rng.integers(0, 20, len(ss)))
    pdb_fn = f"{tag}_struct.pdb"
    bb = build_backbone(ss)
    write_pdb(os.path.join(out_dir, pdb_fn), seq, bb,
              helix_ranges=_sse_ranges(ss, "H"),
              sheet_ranges=_sse_ranges(ss, "E"))
    with open(os.path.join(out_dir, f"templ_{tag}.prof"), "w") as f:
        f.write(profile_text(rng, f"t{tag}", seq, ss, pdb_name=pdb_fn))
    qseq = "".join(AA[i] for i in rng.integers(0, 20, query_len))
    qss = "".join(rng.choice(list("HEC"), query_len,
                             p=[0.35, 0.25, 0.40]))
    with open(os.path.join(out_dir, f"query_{tag}.prof"), "w") as f:
        f.write(profile_text(rng, f"q{tag}", qseq, qss))


def _sse_ranges0(ss: str, kind: str):
    """0-based inclusive ranges (write_pdb_real's convention)."""
    return [(a - 1, b - 1) for a, b in _sse_ranges(ss, kind)]


def make_fixture_real(out_dir: str, seed: int = 23):
    """Realistic-scale fixture: ~250-residue alpha/beta fold written as a
    deposited-style PDB (altLocs, insertion code, author-numbering break,
    MSE HETATM, missing atoms, second chain, waters/ligand — see
    make_pdb.write_pdb_real) plus matching SMAP template and 180-residue
    query profiles.  The reference was built for
    real proteins (gn2lib_seq.cpp:96-201); this is the at-scale battery
    input."""
    rng = np.random.default_rng(seed)
    # four-layer alpha/beta fold, 10 helices / 10 strands, ~230 residues
    segs = []
    for k in range(10):
        segs += ["C" * int(rng.integers(2, 5)),
                 "H" * int(rng.integers(9, 15)),
                 "C" * int(rng.integers(2, 4)),
                 "E" * int(rng.integers(5, 8))]
    ss = "".join(segs) + "CC"
    seq = "".join(AA[i] for i in rng.integers(0, 20, len(ss)))
    pdb_fn = "real_struct.pdb"
    bb = build_backbone(ss)
    numbering, seq, info = write_pdb_real(
        os.path.join(out_dir, pdb_fn), seq, bb,
        helix_ranges=_sse_ranges0(ss, "H"),
        sheet_ranges=_sse_ranges0(ss, "E"), seed=seed)
    with open(os.path.join(out_dir, "templ_real.prof"), "w") as f:
        f.write(profile_text(rng, "treal", seq, ss, pdb_name=pdb_fn))
    # query: a remote homolog — a 180-residue excerpt of the template with
    # 30% point mutations (same SSE architecture, so the fragment graph has
    # real signal at realistic divergence)
    lo = 20
    qseq = list(seq[lo:lo + 180])
    qss = ss[lo:lo + 180]
    for i in range(len(qseq)):
        if rng.random() < 0.30:
            qseq[i] = AA[int(rng.integers(0, 20))]
    with open(os.path.join(out_dir, "query_real.prof"), "w") as f:
        f.write(profile_text(rng, "qreal", "".join(qseq), qss))
    return ss, seq, info


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "tests/data"
    # larger fold: H(12) E(6) E(6) H(9) E(5) with coil linkers
    ss = ("CC" + "H" * 12 + "CCC" + "E" * 6 + "CC" + "E" * 6
          + "CCC" + "H" * 9 + "CC" + "E" * 5 + "C")
    make_fixture(out, "big", ss, query_len=52, seed=17)
    print("wrote", out, "tag=big, templ len", len(ss))
    ss_r, seq_r, info = make_fixture_real(out)
    print("wrote", out, "tag=real, templ len", len(ss_r), info)
