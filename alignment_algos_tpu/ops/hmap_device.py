"""Device-side HMAP similarity/cost producer.

Replaces the host `HMAPaliEval.build_costs` similarity pipeline for
library screens: per-position profile data (25 KB/sequence) ships to the
device ONCE per library/query, and the full z-normalized similarity
matrix is rebuilt on device BIT-IDENTICALLY to the host path, then
scored there by the exact general-gap engine (ops/dp_scores).  Neither
the Q*T similarity nor the (T, T) deletion tables cross between host
and device; only the (n,) scores come back.

Reference semantics being replicated (hmap_eval.h:47-61, hmap_eval.cpp:
38-51, simmatrix.h:50-73):
  ip   = dot20(q_profile_i, t_profile_j)          sequential-K f32 adds
  pc   = pearson3(q_sse_i, t_sse_j)               row z-norms hoisted
  arg  = ((alpha*pc)*conf_q_i)*conf_t_j
  S    = ip * expf(arg);  nan_to_num;  borders zeroed
  z-normalize S[1:-1, 1:-1) in row-major SEQUENTIAL f32 order, shift by
  -zero_shift, re-zero borders.

Bit-exactness mechanics (verified bitwise against the host path in
tests/test_hmap_device.py, and on the GPU by chip_smoke.py):
- f32 multiply/add/subtract are IEEE on the XLA backends -> used direct,
  with every multiply that feeds an add wrapped in sf64.nofma so no
  backend contracts the pair into one FMA.
- expf is the sf64 replica of this libm's __expf_fma (exhaustively
  validated; see ops/sf64.py).  Arguments are finite and < 8 in practice
  (|alpha| * conf^2 bounds them); nonfinite/huge args reproduce the
  host's nan_to_num outcome explicitly.
- f32 division and sqrt are not correctly rounded under XLA:GPU's
  defaults (docs/DECISIONS.md) -> sf64.div32 / sf64.sqrt32
  (integer-corrected, exact).
- the z-norm's mean/variance sums are STRICTLY SEQUENTIAL f32 adds in
  row-major region order (utils/hmath.seq_sum_f32 semantics): computed
  by an 8-unrolled lax.fori_loop chain, vectorized ACROSS pairs only.
- the per-sequence SSE row z-norms of pearson_rows depend only on one
  sequence -> computed on host at pack time with the host code itself.

Known deviation (documented, docs/DECISIONS.md): finite similarity
arguments with 87 < |arg| < 88 would take the libm main path into
subnormal/huge-f32 territory; the device clamps them to the 0/+inf
limit.  Reachable only through degenerate profiles (|pearson| >> 1 via
near-zero SSE variance); the packer detects finite-arg bounds > 87 is
impossible to check host-side cheaply, so the deviation is accepted and
tested for non-occurrence on real data.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..scoring.base import _DEL_FREE_OVERHANG_MODES, ins_zero_flags
from ..utils.hmath import seq_sum_f32
from ..utils.params import AlignT
from . import sf64

F = jnp.float32


# --------------------------------------------------------------------------
# host-side packing (per sequence; tiny, shipped once)
# --------------------------------------------------------------------------

def _znorm_rows_host(rows: np.ndarray) -> np.ndarray:
    """The per-row z-norm inside utils/hmath.pearson_rows, verbatim."""
    rows = rows.astype(np.float32)
    k = rows.shape[1]
    avg = (seq_sum_f32(rows, axis=1) / np.float32(k))[:, None]
    sumsq = seq_sum_f32(rows * rows, axis=1)[:, None]
    var = sumsq / np.float32(k) - avg * avg
    std = np.sqrt(var).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        return ((rows - avg) / std).astype(np.float32)


def pack_sequence(seq) -> dict:
    """Per-sequence device payload: profile, z-normed SSE rows,
    confidences.  ~25 KB per 256-residue sequence vs the 266 KB/pair
    similarity it replaces."""
    return {
        "aa": np.ascontiguousarray(seq.aa_profile, np.float32),
        "zsse": _znorm_rows_host(seq.sse_values),
        "conf": np.ascontiguousarray(seq.sse_confid, np.float32),
    }


def pack_template_costs(ev, templ) -> dict:
    """Per-template gap machinery (host; identical to build_costs)."""
    gi_vec, ge_vec = ev._gap_vectors(templ)
    A = np.minimum(gi_vec, np.roll(gi_vec, 1)).astype(np.float32)
    B = np.minimum(ge_vec, np.roll(ge_vec, 1)).astype(np.float32)
    return {"gi": gi_vec.astype(np.float32), "ge": ge_vec.astype(np.float32),
            "A": A, "B": B}


# --------------------------------------------------------------------------
# device-side similarity build
# --------------------------------------------------------------------------

def _seq_dot(a, b, z):
    """(q2, K) x (n, t2, K) -> (n, q2, t2) with the sequential-in-K f32
    accumulation order of utils/hmath.seq_matmul_f32.  Every product is
    wrapped in sf64.nofma(.., z) so XLA:CPU cannot contract the
    mul-then-add into a single-rounding fmuladd (z is a traced uint32
    zero; see sf64.nofma)."""
    k = a.shape[1]
    out = sf64.nofma(a[None, :, 0:1] * b[:, None, :, 0], z)
    for i in range(1, k):
        out = out + sf64.nofma(a[None, :, i:i + 1] * b[:, None, :, i], z)
    return out


def _expf_ieee(arg):
    """Host expf semantics on f32: sf64 replica on the validated main
    domain; IEEE limits (+inf / +0) outside it; nan passthrough."""
    finite = jnp.isfinite(arg)
    small = finite & (jnp.abs(arg) < F(87.0))
    safe = jnp.where(small, arg, F(0.0))
    e = sf64.bits_f32(sf64.expf_bits(sf64.f32_bits(safe)))
    big = jnp.where(arg > 0, F(jnp.inf), F(0.0))
    return jnp.where(small, e, jnp.where(finite, big, arg))


def _div32_ieee(a, b):
    """fl32(a/b) with IEEE special-value semantics: exact integer-
    corrected division on (finite a, finite nonzero b); the nonfinite /
    zero-divisor cases produce the IEEE limit values."""
    fin = jnp.isfinite(a) & jnp.isfinite(b) & (b != F(0.0))
    q = sf64.bits_f32(sf64.div32(sf64.f32_bits(jnp.where(fin, a, F(1.0))),
                                 sf64.f32_bits(jnp.where(fin, b, F(1.0)))))
    ieee = a / jnp.where(fin, F(1.0), b)   # backend handles inf/nan/0 cases
    return jnp.where(fin, q, ieee)


@functools.partial(jax.jit, static_argnames=("q2", "t2", "normalize"))
def build_similarity_device(q_aa, q_zsse, q_conf, t_aa, t_zsse, t_conf,
                            alpha, zero_shift, fma_guard, *, q2: int,
                            t2: int, normalize: bool = True):
    """(n, q2, t2) z-normalized, shifted similarity stack, bit-identical
    to HMAPaliEval.build_costs's S for each pair (query, templates[i]).

    fma_guard: a TRACED jnp.uint32(0) (see sf64.nofma)."""
    z = fma_guard
    ip = _seq_dot(q_aa, t_aa, z)                       # (n, q2, t2)

    dot3 = _seq_dot(q_zsse, t_zsse, z)
    pc = _div32_ieee(dot3, jnp.broadcast_to(F(3.0), dot3.shape))
    arg = (alpha * pc)
    arg = arg * q_conf[None, :, None]
    arg = arg * t_conf[:, None, :]
    e = _expf_ieee(arg)
    S = ip * e
    S = jnp.where(jnp.isfinite(S), S, F(0.0))          # nan_to_num

    border = jnp.zeros((q2, t2), jnp.bool_)
    border = border.at[0, :].set(True).at[-1, :].set(True)
    border = border.at[:, 0].set(True).at[:, -1].set(True)
    S = jnp.where(border[None], F(0.0), S)

    if normalize:
        avg, std = _znorm_scalars(S, z, q2=q2, t2=t2)
        Sn = _div32_ieee(S - avg[:, None, None],
                         jnp.broadcast_to(std[:, None, None], S.shape))
        S = jnp.where(border[None], S, Sn)
    S = jnp.where(border[None], S, S + zero_shift)
    S = jnp.where(border[None], F(0.0), S)
    return S


@functools.partial(jax.jit, static_argnames=("q2", "t2"))
def _znorm_scalars(S, z, *, q2: int, t2: int):
    """Sequential-order mean/std of the [1:-1, 1:-1) region, exactly as
    hmath.norm_elements_vec: a strictly serial f32 addition chain in
    row-major region order, one chain per pair (pairs stay vectorized).
    Returns (avg, std) of shape (n,)."""
    n = S.shape[0]
    region = S[:, 1:q2 - 1, 1:t2 - 1].reshape(n, -1)
    m = region.shape[1]
    v = region.T                                       # (m, n): serial axis 0
    bulk = m - (m % 8)

    def body(i, carry):
        acc, acc2 = carry
        blk = jax.lax.dynamic_slice_in_dim(v, i * 8, 8, axis=0)
        for r in range(8):
            acc = acc + blk[r]
            # nofma: no fmuladd contraction (see sf64.nofma)
            acc2 = acc2 + sf64.nofma(blk[r] * blk[r], z)
        return acc, acc2

    zero_acc = jnp.zeros((n,), F)
    # the chain must start from the true first element (a zero init adds
    # fl(0 + x) = x exactly, so a zero accumulator is safe)
    acc, acc2 = jax.lax.fori_loop(0, bulk // 8, body, (zero_acc, zero_acc))
    for r in range(bulk, m):
        acc = acc + v[r]
        acc2 = acc2 + sf64.nofma(v[r] * v[r], z)

    nf = jnp.broadcast_to(F(m), (n,))
    avg = _div32_ieee(acc, nf)
    var = _div32_ieee(acc2, nf) - sf64.nofma(avg * avg, z)
    fin = jnp.isfinite(var) & (var >= F(0.0))
    std = sf64.bits_f32(sf64.sqrt32(sf64.f32_bits(
        jnp.where(fin, var, F(1.0)))))
    std = jnp.where(fin, std, jnp.sqrt(var))           # nan for var<0, inf
    return avg, std


# --------------------------------------------------------------------------
# screen orchestration
# --------------------------------------------------------------------------

class DeviceLibrary:
    """A resident, shape-bucketed template library for HMAP screens."""

    def __init__(self, templates, ev):
        self.templates = templates
        self.buckets: dict[int, dict] = {}
        for idx, t in enumerate(templates):
            L = t.size()
            b = self.buckets.setdefault(L, {"idx": [], "seq": [], "cost": []})
            b["idx"].append(idx)
            b["seq"].append(pack_sequence(t))
            b["cost"].append(pack_template_costs(ev, t))
        for L, b in self.buckets.items():
            b["aa"] = jnp.asarray(np.stack([s["aa"] for s in b["seq"]]))
            b["zsse"] = jnp.asarray(np.stack([s["zsse"] for s in b["seq"]]))
            b["conf"] = jnp.asarray(np.stack([s["conf"] for s in b["seq"]]))
            b["D"] = jnp.asarray(np.stack(
                [np.stack([c["gi"], c["ge"]]) for c in b["cost"]]))
            b["A"] = jnp.asarray(np.stack([c["A"] for c in b["cost"]]))
            b["B"] = jnp.asarray(np.stack([c["B"] for c in b["cost"]]))
            del b["seq"], b["cost"]


def screen_hmap_device(query, templates, params, k: int = 10,
                       library: DeviceLibrary | None = None, ev=None):
    """One HMAP query against a template library with the similarity
    built and scored ON DEVICE; scores bit-identical to
    parallel.screen.screen_profiles over host cost builds."""
    from ..scoring.hmap_eval import HMAPaliEval
    from . import dp_scores

    if ev is None:
        ev = HMAPaliEval(params)
    if library is None:
        library = DeviceLibrary(templates, ev)
    qp = pack_sequence(query)
    q2 = query.size()
    at = AlignT(params.align_type)
    zh, zt = ins_zero_flags(at)
    z = jnp.uint32(0)

    scores = np.zeros(len(library.templates), np.float32)
    for t2, b in library.buckets.items():
        S = build_similarity_device(
            jnp.asarray(qp["aa"]), jnp.asarray(qp["zsse"]),
            jnp.asarray(qp["conf"]), b["aa"], b["zsse"], b["conf"],
            F(np.float32(params.alpha)),
            F(np.float32(-np.float32(params.zero_shift))), z,
            q2=q2, t2=t2, normalize=bool(params.normalize_mtx))
        sc = np.asarray(dp_scores.batch_scores(
            S, b["D"], b["A"], b["B"], jnp.zeros((S.shape[0], t2), F), z,
            local=False, zero_head=zh, zero_tail=zt, off=2, has_c=False,
            vec_d=True, del_free=at in _DEL_FREE_OVERHANG_MODES))
        scores[b["idx"]] = sc
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return scores, order
