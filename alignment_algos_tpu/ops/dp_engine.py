"""Vectorized general-gap DP engine (JAX/XLA).

Computes the reference recurrence (dpmatrix.h:356-536) as a `lax.scan` over
query rows: each row computes all its deletion candidates as one masked
(T,T) reduction over the previous row and all its insertion candidates as one
masked (Q,T) reduction over the column history, entirely on the VPU.  This
replaces the reference's per-cell scalar loops (O(Q*T*(Q+T)) sequential) with
O(Q) sequential steps of O(T*(Q+T)) parallel work.

Candidate ordering and strict-improvement tie-breaking are preserved exactly
(match first, then deletions by ascending k, then insertions by ascending k;
`argmax` picks the first maximum which equals the reference's running
strict-> update).  The reverse build runs the forward engine on
index-reversed inputs, which reproduces the reference's descending candidate
order, then maps indices back (and optionally replicates the traceback defect
at dpmatrix.h:868 — see dp_ref.build_reverse).

Arithmetic is float32 in the reference's op order: (H - gap) + sim.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..scoring.base import DPCosts
from .dp_ref import NULL, DPResult

NEG = jnp.float32(-3.0e38)


@partial(jax.jit, static_argnames=("q0", "q1", "t0", "t1", "local",
                                   "zero_head", "zero_tail", "traceback"))
def _dp_forward(S, D, CpadR, ins0, ins_close, *, q0: int, q1: int, t0: int,
                t1: int, local: bool, zero_head: bool, zero_tail: bool,
                traceback: bool = True):
    """CpadR = reversed Cpad, where Cpad[(q2-1)+d, j] = insertion cost
    for a query gap of span d ending at template column j, precomputed in
    the reference's exact float32 mul-then-add (no FMA contraction inside
    the kernel).  ins0 / ins_close are the boundary-column / closing-scan
    cost vectors.  ``traceback=False`` computes H only (no argmax work)
    and returns None for the four traceback outputs."""
    q2, t2 = S.shape
    f32 = jnp.float32
    s_init = f32(0.0)

    jj = jnp.arange(t2)
    ii = jnp.arange(q2)

    def clamp(x):
        return jnp.maximum(f32(0.0), x) if local else x

    # ---- boundary row i = q0+1 ------------------------------------------
    brow_del = clamp((s_init - D[t0, :]) + S[q0 + 1, :])
    brow = jnp.where(jj == t0 + 1, clamp(s_init + S[q0 + 1, t0 + 1]), brow_del)
    brow_mask = (jj >= t0 + 1) & (jj <= t1 - 1)
    brow = jnp.where(brow_mask, brow, f32(0.0))

    # ---- boundary col j = t0+1 (insertion from origin) -------------------
    bcol = clamp((s_init - ins0) + S[:, t0 + 1])

    H0 = jnp.zeros((q2, t2), dtype=jnp.float32)
    H0 = H0.at[q0 + 1].set(brow)
    H0 = jnp.where((ii[:, None] >= q0 + 2) & (ii[:, None] <= q1 - 1)
                   & (jj[None, :] == t0 + 1),
                   bcol[:, None], H0)

    # static masks for candidate ranges
    kk = jnp.arange(t2)
    del_kmask = (kk[:, None] >= t0 + 1) & (kk[:, None] <= jj[None, :] - 2)
    interior_j = (jj >= t0 + 2) & (jj <= t1 - 1)
    qk = jnp.arange(q2)

    def step(H, i):
        Hprev = H[i - 1]
        sim = S[i]

        # diagonal predecessor = Hprev shifted right by one column (edge
        # duplicate matches the old clamped-index gather at j==0, which the
        # boundary masking discards anyway)
        match = clamp(jnp.concatenate([Hprev[:1], Hprev[:-1]]) + sim)

        # deletion candidates: (T2, T2) over predecessor k (prev row)
        dc = clamp((Hprev[:, None] - D) + sim[None, :])
        dc = jnp.where(del_kmask, dc, NEG)
        del_max = jnp.max(dc, axis=0)

        # insertion candidates: (Q2, T2) over predecessor row k (col j-1);
        # cost[k, j] = Cpad[(q2-1) + i - k, j] = CpadR[(q2 - i) + k, j]
        # (CpadR is Cpad row-reversed on host: one slice, no per-row flip)
        Hsh = jnp.concatenate([jnp.zeros((q2, 1), jnp.float32), H[:, :-1]], axis=1)
        cost = jax.lax.dynamic_slice_in_dim(CpadR, q2 - i, q2, axis=0)
        ic = clamp((Hsh - cost) + sim[None, :])
        ins_kmask = (qk[:, None] >= q0 + 1) & (qk[:, None] <= i - 2)
        ic = jnp.where(ins_kmask, ic, NEG)
        ins_max = jnp.max(ic, axis=0)
        if not traceback:
            best = jnp.maximum(match, jnp.maximum(del_max, ins_max))
            return H.at[i].set(jnp.where(interior_j, best, H[i])), None
        del_arg = jnp.argmax(dc, axis=0)
        ins_arg = jnp.argmax(ic, axis=0)

        best = match
        bq = jnp.full(t2, -1, jnp.int32) + jnp.int32(i)  # i-1
        bt = (jj - 1).astype(jnp.int32)
        use_del = del_max > best
        best = jnp.where(use_del, del_max, best)
        bt = jnp.where(use_del, del_arg.astype(jnp.int32), bt)
        use_ins = ins_max > best
        best = jnp.where(use_ins, ins_max, best)
        bq = jnp.where(use_ins, ins_arg.astype(jnp.int32), bq)
        bt = jnp.where(use_ins, (jj - 1).astype(jnp.int32), bt)

        row = jnp.where(interior_j, best, H[i])
        pq_row = jnp.where(interior_j, bq, jnp.int32(NULL))
        pt_row = jnp.where(interior_j, bt, jnp.int32(NULL))
        H = H.at[i].set(row)
        return H, (pq_row, pt_row)

    n_rows = max(q1 - q0 - 2, 0)
    rows = q0 + 2 + jnp.arange(n_rows)
    H, ys = jax.lax.scan(step, H0, rows)
    pq_rows, pt_rows = ys if traceback else (None, None)

    # ---- closing cell (q1, t1) ------------------------------------------
    sim_c = S[q1, t1]
    match = clamp(H[q1 - 1, t1 - 1] + sim_c)
    dc = clamp((H[q1 - 1, :] - D[:, t1]) + sim_c)
    dmask = (kk >= t0 + 1) & (kk <= t1 - 1)
    dc = jnp.where(dmask, dc, NEG)
    del_max = jnp.max(dc)

    icand = clamp((H[:, t1 - 1] - ins_close) + sim_c)
    imask = (qk >= q0 + 1) & (qk <= q1 - 1)
    icand = jnp.where(imask, icand, NEG)
    ins_max = jnp.max(icand)
    if not traceback:
        best = jnp.maximum(match, jnp.maximum(del_max, ins_max))
        return H.at[q1, t1].set(best), None, None, None, None
    del_arg = jnp.argmax(dc)
    ins_arg = jnp.argmax(icand)

    best = match
    bq = jnp.int32(q1 - 1)
    bt = jnp.int32(t1 - 1)
    use_del = del_max > best
    best = jnp.where(use_del, del_max, best)
    bt = jnp.where(use_del, del_arg.astype(jnp.int32), bt)
    use_ins = ins_max > best
    best = jnp.where(use_ins, ins_max, best)
    bq = jnp.where(use_ins, ins_arg.astype(jnp.int32), bq)
    bt = jnp.where(use_ins, jnp.int32(t1 - 1), bt)

    H = H.at[q1, t1].set(best)
    return H, pq_rows, pt_rows, bq, bt


def build_forward_jax(c: DPCosts, q0: int, q1: int, t0: int, t1: int,
                      local: bool = False) -> DPResult:
    """Forward build on device; returns host DPResult."""
    q2, t2 = c.q_size, c.t_size
    if q1 <= q0 or t1 <= t0:
        raise ValueError("Illegal bounds building DPM")
    if q1 == q0 + 1 or t1 == t0 + 1:
        from . import dp_ref
        return dp_ref.build_forward(c, q0, q1, t0, t1, local=local)

    zero_head = bool(c.ins_zero_head_q and q0 == 0)
    zero_tail = bool(c.ins_zero_tail_q and q1 == q2 - 1)

    # host-precomputed insertion cost tables (exact reference float32
    # mul-then-add; keeps XLA from FMA-contracting the cost expression)
    d = np.arange(-(q2 - 1), q2 + 1, dtype=np.int64)  # index (q2-1)+d
    Cpad = (c.A[None, :] + c.B[None, :]
            * (d[:, None] - c.ins_dist_offset).astype(np.float32)
            ).astype(np.float32)
    if c.C is not None:
        Cpad = (Cpad + c.C[None, :].astype(np.float32)).astype(np.float32)
    Cpad[d < 2] = 0.0

    ii = np.arange(q2, dtype=np.int64)
    ins0 = c.ins_cost_of_dist(ii - q0, t0 + 1)
    if zero_head:
        ins0 = np.zeros_like(ins0)

    ins_close = c.ins_cost_of_dist(q1 - ii, t1)
    if zero_tail:
        ins_close = np.zeros_like(ins_close)

    H, pq_rows, pt_rows, bq, bt = _dp_forward(
        jnp.asarray(c.S), jnp.asarray(c.D), jnp.asarray(Cpad[::-1].copy()),
        jnp.asarray(ins0), jnp.asarray(ins_close),
        q0=q0, q1=q1, t0=t0, t1=t1, local=local,
        zero_head=zero_head, zero_tail=zero_tail)

    res = DPResult(q2, t2)
    res.H = np.asarray(H)
    # boundary TBs: row q0+1 and col t0+1 all point to the origin
    res.PQ[q0 + 1, t0 + 1 : t1] = q0
    res.PT[q0 + 1, t0 + 1 : t1] = t0
    res.PQ[q0 + 2 : q1, t0 + 1] = q0
    res.PT[q0 + 2 : q1, t0 + 1] = t0
    if q1 - q0 - 2 > 0:
        res.PQ[q0 + 2 : q1] = np.where(np.asarray(pq_rows) == NULL,
                                       res.PQ[q0 + 2 : q1], np.asarray(pq_rows))
        res.PT[q0 + 2 : q1] = np.where(np.asarray(pt_rows) == NULL,
                                       res.PT[q0 + 2 : q1], np.asarray(pt_rows))
    res.PQ[q1, t1] = int(bq)
    res.PT[q1, t1] = int(bt)
    return res


@partial(jax.jit, static_argnames=("q0", "q1", "t0", "t1", "local",
                                   "zero_head", "zero_tail"))
def _dp_forward_batched(S, D, CpadR, ins0, ins_close, *, q0, q1, t0, t1,
                        local, zero_head, zero_tail):
    """vmap of the forward engine over a leading batch axis — the exact
    general-gap DP for B same-shape pairs in one device program (profile
    library screens with reference scoring)."""
    fn = partial(_dp_forward.__wrapped__, q0=q0, q1=q1, t0=t0, t1=t1,
                 local=local, zero_head=zero_head, zero_tail=zero_tail)
    return jax.vmap(fn)(S, D, CpadR, ins0, ins_close)


def build_forward_jax_batched(costs: list[DPCosts], local: bool = False):
    """Full forward builds for a batch of same-shape cost models; returns a
    list of DPResult.  All pairs must share (Q+2, T+2)."""
    assert costs
    q2, t2 = costs[0].q_size, costs[0].t_size
    for c in costs:
        assert (c.q_size, c.t_size) == (q2, t2), "bucket by shape first"
    q0, t0, q1, t1 = 0, 0, q2 - 1, t2 - 1
    zero_head = bool(costs[0].ins_zero_head_q)
    zero_tail = bool(costs[0].ins_zero_tail_q)

    d = np.arange(-(q2 - 1), q2 + 1, dtype=np.int64)
    ii = np.arange(q2, dtype=np.int64)
    S_b, D_b, Cpad_b, ins0_b, insc_b = [], [], [], [], []
    for c in costs:
        Cpad = (c.A[None, :] + c.B[None, :]
                * (d[:, None] - c.ins_dist_offset).astype(np.float32)
                ).astype(np.float32)
        if c.C is not None:
            Cpad = (Cpad + c.C[None, :].astype(np.float32)).astype(np.float32)
        Cpad[d < 2] = 0.0
        ins0 = c.ins_cost_of_dist(ii - q0, t0 + 1)
        if zero_head:
            ins0 = np.zeros_like(ins0)
        ins_close = c.ins_cost_of_dist(q1 - ii, t1)
        if zero_tail:
            ins_close = np.zeros_like(ins_close)
        S_b.append(c.S)
        D_b.append(c.D)
        Cpad_b.append(Cpad)
        ins0_b.append(ins0)
        insc_b.append(ins_close)

    H, pq_rows, pt_rows, bq, bt = _dp_forward_batched(
        jnp.asarray(np.stack(S_b)), jnp.asarray(np.stack(D_b)),
        jnp.asarray(np.stack(Cpad_b)[:, ::-1].copy()), jnp.asarray(np.stack(ins0_b)),
        jnp.asarray(np.stack(insc_b)),
        q0=q0, q1=q1, t0=t0, t1=t1, local=local,
        zero_head=zero_head, zero_tail=zero_tail)

    H = np.asarray(H)
    pq_rows = np.asarray(pq_rows)
    pt_rows = np.asarray(pt_rows)
    bq = np.asarray(bq)
    bt = np.asarray(bt)
    out = []
    for b in range(len(costs)):
        res = DPResult(q2, t2)
        res.H = H[b]
        res.PQ[q0 + 1, t0 + 1 : t1] = q0
        res.PT[q0 + 1, t0 + 1 : t1] = t0
        res.PQ[q0 + 2 : q1, t0 + 1] = q0
        res.PT[q0 + 2 : q1, t0 + 1] = t0
        if q1 - q0 - 2 > 0:
            res.PQ[q0 + 2 : q1] = np.where(pq_rows[b] == NULL,
                                           res.PQ[q0 + 2 : q1], pq_rows[b])
            res.PT[q0 + 2 : q1] = np.where(pt_rows[b] == NULL,
                                           res.PT[q0 + 2 : q1], pt_rows[b])
        res.PQ[q1, t1] = int(bq[b])
        res.PT[q1, t1] = int(bt[b])
        out.append(res)
    return out


def _flip_costs(c: DPCosts) -> DPCosts:
    """Mirror the cost model so the forward engine computes the reverse build."""
    S_f = np.ascontiguousarray(c.S[::-1, ::-1])
    D_f = np.ascontiguousarray(c.D[::-1, ::-1].T)
    A_f = c.A.copy()
    B_f = c.B.copy()
    A_f[1:] = c.A[1:][::-1]
    B_f[1:] = c.B[1:][::-1]
    C_f = None
    if c.C is not None:
        C_f = c.C.copy()
        C_f[1:] = c.C[1:][::-1]
    return DPCosts(S=S_f, D=D_f, A=A_f, B=B_f,
                   ins_zero_head_q=c.ins_zero_tail_q,
                   ins_zero_tail_q=c.ins_zero_head_q,
                   C=C_f, ins_dist_offset=c.ins_dist_offset)


def build_reverse_jax(c: DPCosts, q0: int, q1: int, t0: int, t1: int,
                      local: bool = False, bug_compat: bool = True) -> DPResult:
    """Reverse build on device via the mirrored forward engine."""
    q2, t2 = c.q_size, c.t_size
    if q1 == q0 + 1 or t1 == t0 + 1:
        from . import dp_ref
        return dp_ref.build_reverse(c, q0, q1, t0, t1, local=local,
                                    bug_compat=bug_compat)
    cf = _flip_costs(c)
    fq0, fq1 = q2 - 1 - q1, q2 - 1 - q0
    ft0, ft1 = t2 - 1 - t1, t2 - 1 - t0
    fres = build_forward_jax(cf, fq0, fq1, ft0, ft1, local=local)

    res = DPResult(q2, t2)
    res.H = np.ascontiguousarray(fres.H[::-1, ::-1])
    pq = fres.PQ[::-1, ::-1]
    pt = fres.PT[::-1, ::-1]
    valid = pq != NULL
    res.PQ = np.where(valid, (q2 - 1) - pq, NULL).astype(np.int32)
    res.PT = np.where(valid, (t2 - 1) - pt, NULL).astype(np.int32)
    if bug_compat and not local:
        # dpmatrix.h:868 — closing-cell insertion winner records t1-1
        if res.PQ[q0, t0] > q0 + 1 and res.PT[q0, t0] == t0 + 1:
            res.PT[q0, t0] = t1 - 1
    return res
