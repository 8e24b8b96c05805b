"""Shared test helpers: random cost models and a brute-force DP oracle
written directly from the recurrence specification (independent of
ops/dp_ref.py's implementation)."""

from __future__ import annotations

import numpy as np

from alignment_algos_tpu.scoring.base import DPCosts, affine_deletion_table
from alignment_algos_tpu.utils.params import AlignT

F32 = np.float32


def random_costs(rng, q2: int, t2: int, align_type=AlignT.GLOBAL,
                 zero_flags=False, vectors=False) -> DPCosts:
    """Random cost model; ``vectors`` also records the per-position gap
    vectors D was built from (the device-rebuild path of ops/dp_scores)."""
    S = rng.standard_normal((q2, t2)).astype(np.float32) * F32(2.0)
    S[0, :] = 0
    S[-1, :] = 0
    S[:, 0] = 0
    S[:, -1] = 0
    gi = (rng.uniform(0.5, 5.0, t2)).astype(np.float32)
    ge = (rng.uniform(0.05, 1.0, t2)).astype(np.float32)
    gi_pair = np.minimum(gi[:, None], gi[None, :]).astype(np.float32)
    ge_pair = np.minimum(ge[:, None], ge[None, :]).astype(np.float32)
    D = affine_deletion_table(gi_pair, ge_pair, align_type)
    A = np.minimum(gi, np.roll(gi, 1)).astype(np.float32)
    B = np.minimum(ge, np.roll(ge, 1)).astype(np.float32)
    vec = dict(del_gi_vec=gi, del_ge_vec=ge, del_align=AlignT(align_type)) \
        if vectors else {}
    return DPCosts(S=S, D=D, A=A, B=B,
                   ins_zero_head_q=zero_flags, ins_zero_tail_q=zero_flags,
                   **vec)


def brute_force_dp(c: DPCosts, q0, q1, t0, t1, local=False):
    """Direct nested-loop evaluation of the recurrence (float32), including
    boundary and closing special cases.  Returns (H, PQ, PT)."""
    q2, t2 = c.q_size, c.t_size
    H = np.zeros((q2, t2), np.float32)
    PQ = np.full((q2, t2), -1, np.int32)
    PT = np.full((q2, t2), -1, np.int32)
    S = c.S

    def clamp(x):
        return max(np.float32(0.0), x) if local else x

    def setc(i, j, pq, pt, s):
        H[i, j] = s
        PQ[i, j] = pq
        PT[i, j] = pt

    if q1 == q0 + 1:
        s = F32(F32(0.0 - F32(c.deletion(q0, q1, t0, t1))) + S[q1, t1])
        setc(q1, t1, q0, t0, s)
        return H, PQ, PT
    if t1 == t0 + 1:
        s = F32(F32(0.0 - F32(c.insertion(q0, q1, t0, t1))) + S[q1, t1])
        setc(q1, t1, q0, t0, s)
        return H, PQ, PT

    setc(q0 + 1, t0 + 1, q0, t0, clamp(F32(S[q0 + 1, t0 + 1])))
    for j in range(t0 + 2, t1):
        setc(q0 + 1, j, q0, t0,
             clamp(F32(F32(0.0 - F32(c.deletion(q0, q0 + 1, t0, j))) + S[q0 + 1, j])))
    for i in range(q0 + 2, q1):
        setc(i, t0 + 1, q0, t0,
             clamp(F32(F32(0.0 - F32(c.insertion(q0, i, t0, t0 + 1))) + S[i, t0 + 1])))

    for i in range(q0 + 2, q1):
        for j in range(t0 + 2, t1):
            oi, oj = i - 1, j - 1
            os_ = clamp(F32(H[i - 1, j - 1] + S[i, j]))
            for k in range(t0 + 1, j - 1):
                s = clamp(F32(F32(H[i - 1, k] - F32(c.deletion(i - 1, i, k, j))) + S[i, j]))
                if s > os_:
                    oi, oj, os_ = i - 1, k, s
            for k in range(q0 + 1, i - 1):
                s = clamp(F32(F32(H[k, j - 1] - F32(c.insertion(k, i, j - 1, j))) + S[i, j]))
                if s > os_:
                    oi, oj, os_ = k, j - 1, s
            setc(i, j, oi, oj, os_)

    oi, oj = q1 - 1, t1 - 1
    os_ = clamp(F32(H[q1 - 1, t1 - 1] + S[q1, t1]))
    for k in range(t0 + 1, t1):
        s = clamp(F32(F32(H[q1 - 1, k] - F32(c.deletion(q1 - 1, q1, k, t1))) + S[q1, t1]))
        if s > os_:
            oi, oj, os_ = q1 - 1, k, s
    for k in range(q0 + 1, q1):
        s = clamp(F32(F32(H[k, t1 - 1] - F32(c.insertion(k, q1, t1 - 1, t1))) + S[q1, t1]))
        if s > os_:
            oi, oj, os_ = k, t1 - 1, s
    setc(q1, t1, oi, oj, os_)
    return H, PQ, PT
