"""Batched affine-gap Smith-Waterman in plain XLA: the anti-diagonal
wavefront engine, its traceback twin, and their similarity producers.

B sequence pairs are aligned simultaneously with the classic Gotoh
3-state recurrence.  For affine gap costs (gi + ge*(len-1),
aasubalib.h:27-77) the Gotoh optimum equals the reference's general-gap
local DP optimum, so scores cross-validate against ops/dp_ref.

Design:
 * similarity matrices come from one-hot contractions
   (codes -> onehot(q) @ table @ onehot(t)^T, float32 at
   Precision.HIGHEST so no TF32 rounding touches fractional tables),
   then are skewed so that anti-diagonal d is a contiguous (Q, B) slab;
 * ``sw_affine_scores_xla`` is a ``lax.scan`` over the anti-diagonals
   carrying the H/E/F wavefronts and the running max;
 * ``sw_affine_tb_xla`` also emits one int8 traceback code per cell,
   decoded into optimal local alignments by ``decode_local_tracebacks``.

The GPU screen engine (ops/swscan) reproduces ``sw_affine_scores_xla``
bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -3.0e38
HIGHEST = jax.lax.Precision.HIGHEST


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def decode_local_tracebacks(tb: np.ndarray, m: np.ndarray, dat: np.ndarray,
                            q: int, t: int, nb: int | None = None):
    """Vectorized host decode of ``sw_affine_tb_xla``'s traceback codes.

    Returns (scores (B,), paths) where paths[b] is the list of matched
    (query_idx, template_idx) 0-based pairs, N-to-C order (empty when the
    best local score is 0)."""
    tb = np.asarray(tb)
    m = np.asarray(m)
    dat = np.asarray(dat)
    b = m.shape[1] if nb is None else nb
    scores = m[:q, :b].max(axis=0)
    bi = m[:q, :b].argmax(axis=0)
    bd = dat[bi, np.arange(b)]

    lanes = np.arange(b)
    i = bi.astype(np.int64)
    j = (bd - bi).astype(np.int64)
    state = np.zeros(b, np.int8)       # 0 = H, 1 = E, 2 = F
    alive = scores > 0.0
    # matched (i, j) per (step, lane), -1 where no match: the per-lane
    # paths are mask-extracted afterwards instead of appended in the loop
    # (the per-step per-lane python appends dominated large decodes)
    max_steps = q + t + 2
    rec_i = np.full((max_steps, b), -1, np.int32)
    rec_j = np.full((max_steps, b), -1, np.int32)
    for step in range(max_steps):
        if not alive.any():
            break
        inb = alive & (i >= 0) & (j >= 0)
        alive = inb
        if not alive.any():
            break
        c = np.zeros(b, np.int8)
        al = np.where(alive)[0]
        c[al] = tb[i[al] + j[al], i[al], lanes[al]]
        in_h = alive & (state == 0)
        hb = c & 3
        stop = in_h & (hb == 0)
        alive = alive & ~stop
        match = alive & (state == 0) & (hb == 1)
        rec_i[step, match] = i[match]
        rec_j[step, match] = j[match]
        to_e = alive & (state == 0) & (hb == 2)
        to_f = alive & (state == 0) & (hb == 3)
        state = np.where(to_e, 1, np.where(to_f, 2, state)).astype(np.int8)
        i = np.where(match, i - 1, i)
        j = np.where(match, j - 1, j)
        in_e = alive & (state == 1) & ~to_e & ~match
        in_e = in_e | to_e
        in_f = (alive & (state == 2) & ~to_f & ~match) | to_f
        # E consumes one template column; leaves E when the open bit won
        e_ext = (c & 4) != 0
        f_ext = (c & 8) != 0
        j = np.where(in_e, j - 1, j)
        state = np.where(in_e & ~e_ext, 0, state).astype(np.int8)
        i = np.where(in_f, i - 1, i)
        state = np.where(in_f & ~f_ext, 0, state).astype(np.int8)
    paths = []
    for lane in range(b):
        msk = rec_i[:, lane] >= 0
        pi = rec_i[msk, lane][::-1]
        pj = rec_j[msk, lane][::-1]
        paths.append(list(zip(pi.tolist(), pj.tolist())))
    return scores, paths


@functools.partial(jax.jit, static_argnames=("q", "t", "b"))
def _decode_tb_device(tb, m, dat, *, q: int, t: int, b: int):
    """Device-side port of decode_local_tracebacks' per-step loop: the
    multi-MB traceback code array never leaves the device — only the
    (max_steps, B) matched-pair records do (a ~30x smaller pull)."""
    lanes = jnp.arange(b)
    mq = m[:q, :b]
    scores = jnp.max(mq, axis=0)
    bi = jnp.argmax(mq, axis=0).astype(jnp.int32)
    bd = dat[bi, lanes].astype(jnp.int32)
    max_steps = q + t + 2
    i = bi
    j = bd - bi
    state = jnp.zeros(b, jnp.int8)
    alive = scores > 0.0
    rec_i = jnp.full((max_steps, b), -1, jnp.int32)
    rec_j = jnp.full((max_steps, b), -1, jnp.int32)

    def body(step, carry):
        i, j, state, alive, rec_i, rec_j = carry
        alive = alive & (i >= 0) & (j >= 0)
        d0 = jnp.clip(i + j, 0, tb.shape[0] - 1)
        i0 = jnp.clip(i, 0, tb.shape[1] - 1)
        c = jnp.where(alive, tb[d0, i0, lanes], 0).astype(jnp.int8)
        hb = c & 3
        in_h = alive & (state == 0)
        stop = in_h & (hb == 0)
        alive = alive & ~stop
        match = alive & (state == 0) & (hb == 1)
        rec_i = rec_i.at[step].set(jnp.where(match, i, -1))
        rec_j = rec_j.at[step].set(jnp.where(match, j, -1))
        to_e = alive & (state == 0) & (hb == 2)
        to_f = alive & (state == 0) & (hb == 3)
        state = jnp.where(to_e, 1, jnp.where(to_f, 2, state)).astype(jnp.int8)
        i = jnp.where(match, i - 1, i)
        j = jnp.where(match, j - 1, j)
        in_e = (alive & (state == 1) & ~to_e & ~match) | to_e
        in_f = (alive & (state == 2) & ~to_f & ~match) | to_f
        e_ext = (c & 4) != 0
        f_ext = (c & 8) != 0
        j = jnp.where(in_e, j - 1, j)
        state = jnp.where(in_e & ~e_ext, 0, state).astype(jnp.int8)
        i = jnp.where(in_f, i - 1, i)
        state = jnp.where(in_f & ~f_ext, 0, state).astype(jnp.int8)
        return (i, j, state, alive, rec_i, rec_j)

    carry = jax.lax.fori_loop(0, max_steps, body,
                              (i, j, state, alive, rec_i, rec_j))
    return scores, carry[4], carry[5]


def decode_local_tracebacks_device(tb, m, dat, q: int, t: int,
                                   nb: int | None = None):
    """Device decode + tiny host path extraction; same (scores, paths) as
    decode_local_tracebacks, asserted equal in tests/test_swaffine.py."""
    b = m.shape[1] if nb is None else nb
    scores, rec_i, rec_j = _decode_tb_device(tb, m, dat, q=q, t=t, b=b)
    scores = np.asarray(scores)
    rec_i = np.asarray(rec_i)
    rec_j = np.asarray(rec_j)
    paths = []
    for lane in range(b):
        msk = rec_i[:, lane] >= 0
        pi = rec_i[msk, lane][::-1]
        pj = rec_j[msk, lane][::-1]
        paths.append(list(zip(pi.tolist(), pj.tolist())))
    return scores, paths


def skew_similarity(s: jax.Array) -> jax.Array:
    """(B, Q, T) -> (D, Qp, B) where slab d holds S[b, i, d-i].

    Implemented as the pad/reshape diagonal trick (no gathers): pad rows to
    T+Q, flatten, drop, reshape — row i of the result is shifted right by i.
    """
    b, q, t = s.shape
    w = q + t  # padded row width
    d = w - 1  # number of anti-diagonals
    qp = _round_up(q, 8)
    bp = _round_up(b, 128)
    padded = jnp.pad(s, ((0, bp - b), (0, 0), (0, q)))   # (bp, q, w)
    flat = padded.reshape(bp, q * w)[:, : q * (w - 1)]
    skewed = flat.reshape(bp, q, w - 1)  # [b, i, d] = S[b, i, d-i]
    skewed = jnp.pad(skewed, ((0, 0), (0, qp - q), (0, 0)))
    return jnp.transpose(skewed, (2, 1, 0))  # (D, Qp, Bp)


@functools.partial(jax.jit, static_argnames=("sim_dtype",))
def similarity_from_codes(q_codes: jax.Array, t_codes: jax.Array,
                          table: jax.Array, sim_dtype=jnp.float32) -> jax.Array:
    """(B, Q) x (B, T) int codes + (A, A) table -> (B, Q, T) similarity via
    one-hot contractions.  sim_dtype=int8 is exact for integer
    substitution tables (BLOSUM fits [-128, 127]) and quarters the
    memory traffic of the skew + scan passes."""
    a = table.shape[0]
    qoh = jax.nn.one_hot(q_codes, a, dtype=jnp.float32)      # (B, Q, A)
    toh = jax.nn.one_hot(t_codes, a, dtype=jnp.float32)      # (B, T, A)
    qt = jnp.einsum("bqa,ac->bqc", qoh, table.astype(jnp.float32),
                    precision=HIGHEST, preferred_element_type=jnp.float32)
    s = jnp.einsum("bqc,btc->bqt", qt, toh,
                   precision=HIGHEST, preferred_element_type=jnp.float32)
    return s.astype(sim_dtype)


@functools.partial(jax.jit, static_argnames=("sim_dtype",))
def skewed_similarity_from_codes(q_codes: jax.Array, t_codes: jax.Array,
                                 table: jax.Array,
                                 sim_dtype=jnp.float32) -> jax.Array:
    """Fused codes -> skewed similarity with the batch axis kept LAST
    throughout: (B, Q) x (B, T) -> (D, Qp, Bp).

    The einsum emits (Q, T, B) directly, so the diagonal skew only
    permutes the two leading axes and the batch axis stays minor."""
    b, q = q_codes.shape
    t = t_codes.shape[1]
    a = table.shape[0]
    bp = _round_up(b, 128)
    qp = _round_up(q, 8)
    qoh = jax.nn.one_hot(q_codes, a, dtype=jnp.float32)      # (B, Q, A)
    toh = jax.nn.one_hot(t_codes, a, dtype=jnp.float32)      # (B, T, A)
    qt = jnp.einsum("bqa,ac->bqc", qoh, table.astype(jnp.float32),
                    precision=HIGHEST, preferred_element_type=jnp.float32)
    s = jnp.einsum("bqc,btc->qtb", qt, toh, precision=HIGHEST,
                   preferred_element_type=jnp.float32).astype(sim_dtype)
    s = jnp.pad(s, ((0, 0), (0, 0), (0, bp - b)))            # (Q, T, Bp)
    # diagonal skew via the pad/flatten/reshape trick, batch axis untouched:
    # row i of the (Q, W-1) view is shifted right by i, so [i, d] = S[i, d-i]
    w = q + t
    padded = jnp.pad(s, ((0, 0), (0, q), (0, 0)))            # (Q, W, Bp)
    flat = padded.reshape(q * w, bp)[: q * (w - 1)]
    sk = flat.reshape(q, w - 1, bp)                          # [i, d, b]
    sk = jnp.pad(sk, ((0, qp - q), (0, 0), (0, 0)))
    return jnp.transpose(sk, (1, 0, 2))                      # (D, Qp, Bp)


@functools.partial(jax.jit, static_argnames=("q", "t"))
def sw_affine_scores_xla(sd: jax.Array, gap: jax.Array, *, q: int,
                         t: int) -> jax.Array:
    """lax.scan over skewed diagonals.  sd: (D, Qp, B) skewed similarity;
    gap: (1, 2) [gi, ge] -> (B,) scores."""
    nd, qp, b = sd.shape
    gi = gap[0, 0]
    ge = gap[0, 1]
    ii = jax.lax.broadcasted_iota(jnp.int32, (qp, 1), 0)

    def shift_down(x):
        y = jnp.roll(x, 1, axis=0)
        return jnp.where(ii == 0, jnp.float32(0.0), y)

    def step(carry, inp):
        hm1, hm2, e, f, m = carry
        d, s = inp
        s = s.astype(jnp.float32)
        jj = d - ii
        valid = (ii < q) & (jj >= 0) & (jj < t)
        e_new = jnp.maximum(e - ge, hm1 - gi)
        f_new = jnp.maximum(
            jnp.where(ii == 0, NEG, shift_down(f) - ge),
            jnp.where(ii == 0, NEG, shift_down(hm1) - gi))
        h_new = jnp.maximum(jnp.maximum(shift_down(hm2) + s, 0.0),
                            jnp.maximum(e_new, f_new))
        h_new = jnp.where(valid, h_new, 0.0)
        e_new = jnp.where(valid, e_new, NEG)
        f_new = jnp.where(valid, f_new, NEG)
        m = jnp.maximum(m, h_new)
        return (h_new, hm1, e_new, f_new, m), None

    z = jnp.zeros((qp, b), jnp.float32)
    neg = jnp.full((qp, b), NEG, jnp.float32)
    (h, _, _, _, m), _ = jax.lax.scan(
        step, (z, z, neg, neg, z), (jnp.arange(nd), sd))
    return jnp.max(m, axis=0)


@functools.partial(jax.jit, static_argnames=("q", "t"))
def sw_affine_tb_xla(sd: jax.Array, gap: jax.Array, *, q: int, t: int):
    """Traceback variant of ``sw_affine_scores_xla``: per cell one int8
    code (bits 0-1 H source: 0 stop / 1 diag / 2 E / 3 F; bit 2
    E-extend; bit 3 F-extend; ties resolve diag > E > F, open > extend)
    plus the running max and its diagonal index per (row, lane) — the
    device analogue of optimal.h:47-124's stored prev pointers at one
    byte per cell.  Returns (tb (D, Qp, B), m (Qp, B), dat (Qp, B));
    decode with :func:`decode_local_tracebacks`."""
    nd, qp, b = sd.shape
    gi = gap[0, 0]
    ge = gap[0, 1]
    ii = jax.lax.broadcasted_iota(jnp.int32, (qp, 1), 0)

    def shift_down(x):
        y = jnp.roll(x, 1, axis=0)
        return jnp.where(ii == 0, jnp.float32(0.0), y)

    def step(carry, inp):
        hm1, hm2, e, f, m, dat = carry
        d, s = inp
        s = s.astype(jnp.float32)
        jj = d - ii
        valid = (ii < q) & (jj >= 0) & (jj < t)
        e_open = hm1 - gi
        e_ext = e - ge
        e_new = jnp.maximum(e_ext, e_open)
        f_open = jnp.where(ii == 0, NEG, shift_down(hm1) - gi)
        f_ext = jnp.where(ii == 0, NEG, jnp.roll(f, 1, axis=0) - ge)
        f_new = jnp.maximum(f_ext, f_open)
        diag = shift_down(hm2) + s
        h_new = jnp.maximum(jnp.maximum(diag, jnp.float32(0.0)),
                            jnp.maximum(e_new, f_new))
        h_new = jnp.where(valid, h_new, jnp.float32(0.0))
        code = jnp.where(
            h_new == 0.0, 0,
            jnp.where(h_new == diag, 1, jnp.where(h_new == e_new, 2, 3)))
        code = code | jnp.where(e_ext > e_open, 4, 0)
        code = code | jnp.where(f_ext > f_open, 8, 0)
        code = jnp.where(valid, code, 0).astype(jnp.int8)
        upd = h_new > m
        dat = jnp.where(upd, jnp.int32(d), dat)
        m = jnp.where(upd, h_new, m)
        return (h_new, hm1, e_new, f_new, m, dat), code

    z = jnp.zeros((qp, b), jnp.float32)
    neg = jnp.full((qp, b), NEG, jnp.float32)
    di = jnp.zeros((qp, b), jnp.int32)
    (_, _, _, _, m, dat), tb = jax.lax.scan(
        step, (z, z, neg, neg, z, di), (jnp.arange(nd), sd))
    return tb, m, dat


def sw_affine_tb_batch(q_codes, t_codes, table, gi: float, ge: float,
                       sim_dtype=jnp.float32):
    """End-to-end batched local SW **with alignments**: codes -> skewed
    similarity -> ``sw_affine_tb_xla`` -> device decode.  Returns (scores (B,), paths) where paths[b]
    is the optimal local alignment's matched (query_idx, template_idx)
    0-based pairs — the batched device analogue of Optimal::enumerate
    (optimal.h:47-124)."""
    q_codes = jnp.asarray(q_codes)
    t_codes = jnp.asarray(t_codes)
    b, q = q_codes.shape
    t = t_codes.shape[1]
    sd = skewed_similarity_from_codes(q_codes, t_codes, jnp.asarray(table),
                                      sim_dtype=sim_dtype)
    gap = jnp.array([[gi, ge]], dtype=jnp.float32)
    tb, m, dat = sw_affine_tb_xla(sd, gap, q=q, t=t)
    return decode_local_tracebacks_device(tb, m, dat, q, t, nb=b)


def sw_affine_batch_xla(q_codes, t_codes, table, gi: float, ge: float):
    """End-to-end batched SW via the XLA engine (portable)."""
    b, q = q_codes.shape
    t = t_codes.shape[1]
    s = similarity_from_codes(jnp.asarray(q_codes), jnp.asarray(t_codes),
                              jnp.asarray(table))
    sd = skew_similarity(s)
    gap = jnp.array([[gi, ge]], dtype=jnp.float32)
    return sw_affine_scores_xla(sd, gap, q=q, t=t)[:b]


def sw_affine_reference(s: np.ndarray, gi: float, ge: float) -> np.ndarray:
    """Numpy Gotoh SW oracle: s (B, Q, T) -> (B,) scores.  A plain cell
    by cell loop over (i, j), vectorized only across the B pairs."""
    s = np.asarray(s, np.float32)
    b, q, t = s.shape
    gi = np.float32(gi)
    ge = np.float32(ge)
    zero = np.zeros(b, np.float32)
    h_up = np.zeros((t + 1, b), np.float32)          # H[i-1, :]
    f_up = np.full((t + 1, b), -np.inf, np.float32)  # F[i-1, :]
    best = zero.copy()
    for i in range(q):
        h_row = np.zeros((t + 1, b), np.float32)
        f_row = np.full((t + 1, b), -np.inf, np.float32)
        e = np.full(b, -np.inf, np.float32)
        for j in range(1, t + 1):
            e = np.maximum(e - ge, h_row[j - 1] - gi)
            f = np.maximum(f_up[j] - ge, h_up[j] - gi)
            h = np.maximum(np.maximum(zero, h_up[j - 1] + s[:, i, j - 1]),
                           np.maximum(e, f))
            h_row[j] = h
            f_row[j] = f
            best = np.maximum(best, h)
        h_up, f_up = h_row, f_row
    return best
