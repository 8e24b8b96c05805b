"""Batched exact general-gap DP scores on device (scores only).

The optimal global score H[q1, t1] of the reference recurrence
(dpmatrix.h:356-536) for n same-shape pairs in one device program: the
row ``lax.scan`` of ``ops/dp_engine`` with its argmax/traceback work
switched off, vmapped over the pairs.  Only per-pair vectors need to
reach the device — S, the deletion table or its two gap vectors, and the
A/B/C insertion coefficients — because the cost tables are rebuilt on
device here, in the reference's float32 operation order:

  D[k, j]  = min(gi[k], gi[j]) + min(ge[k], ge[j]) * (j-k-2), 0 for j-k < 2
             (scoring.base.affine_deletion_table, with overhang zeroing)
  Cpad     = (A[j] + B[j] * (d - off)) + C[j], 0 for d < 2
             (the host Cpad of dp_engine.build_forward_jax)
  ins0/insc = DPCosts.ins_cost_of_dist at columns t0+1 / t1

Every product that feeds an add passes through ``sf64.nofma`` with a
traced zero, so no backend can contract it into a single-rounding FMA.
Scores are bit-identical to dp_ref / dp_engine (tests/test_dp_scores.py;
on the GPU, chip_smoke.py and tests/test_gpu.py).

``ops/hmap_device`` feeds this engine its device-built similarity stack
directly, so an exact profile screen never moves S or D off the card.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..scoring.base import _DEL_FREE_OVERHANG_MODES, DPCosts
from . import dp_engine, sf64

F = jnp.float32


def _ins_cost(A, Bv, C, dist, z, off: int, has_c: bool):
    """(n, ...) insertion cost for integer spans ``dist`` (broadcast
    against the coefficient columns), DPCosts.ins_cost_of_dist order."""
    cost = A + sf64.nofma(Bv * (dist - off).astype(F), z)
    if has_c:
        cost = cost + C
    return jnp.where(dist < 2, F(0.0), cost)


@partial(jax.jit, static_argnames=("local", "zero_head", "zero_tail", "off",
                                   "has_c", "vec_d", "del_free"))
def batch_scores(S, D, A, Bv, C, z, *, local: bool, zero_head: bool,
                 zero_tail: bool, off: int, has_c: bool, vec_d: bool,
                 del_free: bool):
    """(n,) scores H[q2-1, t2-1] over full bounds.

    S (n, q2, t2); D (n, t2, t2) tables, or with ``vec_d`` (n, 2, t2)
    [gi, ge] per-position vectors; A, Bv, C (n, t2); z a traced
    jnp.uint32(0) (see sf64.nofma)."""
    n, q2, t2 = S.shape
    q1, t1 = q2 - 1, t2 - 1
    if vec_d:
        gi, ge = D[:, 0, :], D[:, 1, :]
        gp = jnp.minimum(gi[:, :, None], gi[:, None, :])
        ep = jnp.minimum(ge[:, :, None], ge[:, None, :])
        kk = jnp.arange(t2, dtype=jnp.int32)[:, None]
        jj = jnp.arange(t2, dtype=jnp.int32)[None, :]
        dist = (jj - kk).astype(F)
        D = gp + sf64.nofma(ep * (dist - F(2.0)), z)
        D = jnp.where(jj - kk < 2, F(0.0), D)
        if del_free:
            D = D.at[:, 0, :].set(F(0.0)).at[:, :, t1].set(F(0.0))
    # Cpad rows d = -(q2-1) .. q2, stored reversed (dp_engine's CpadR)
    d = jnp.arange(q2, -q2, -1, dtype=jnp.int32)[None, :, None]
    cpad_r = _ins_cost(A[:, None, :], Bv[:, None, :], C[:, None, :], d, z,
                       off, has_c)
    ii = jnp.arange(q2, dtype=jnp.int32)[None, :]
    ins0 = _ins_cost(A[:, 1:2], Bv[:, 1:2], C[:, 1:2], ii, z, off, has_c)
    insc = _ins_cost(A[:, t1:t1 + 1], Bv[:, t1:t1 + 1], C[:, t1:t1 + 1],
                     q1 - ii, z, off, has_c)
    if zero_head:
        ins0 = jnp.zeros_like(ins0)
    if zero_tail:
        insc = jnp.zeros_like(insc)
    fwd = partial(dp_engine._dp_forward.__wrapped__, q0=0, q1=q1, t0=0,
                  t1=t1, local=local, zero_head=zero_head,
                  zero_tail=zero_tail, traceback=False)
    H = jax.vmap(lambda *a: fwd(*a)[0])(S, D, cpad_r, ins0, insc)
    return H[:, q1, t1]


def pack_costs(costs: list[DPCosts]):
    """Stack same-shape cost models into ``batch_scores`` arguments:
    (args, static keywords)."""
    q2, t2 = costs[0].q_size, costs[0].t_size
    for c in costs:
        assert (c.q_size, c.t_size) == (q2, t2), "bucket by shape first"
    c0 = costs[0]
    vec_d = all(c.del_gi_vec is not None and c.del_align == c0.del_align
                for c in costs)
    if vec_d:
        # only the two gap vectors cross to the device; D is rebuilt there
        D = np.stack([np.stack([c.del_gi_vec, c.del_ge_vec])
                      for c in costs]).astype(np.float32)
    else:
        D = np.stack([c.D for c in costs])
    C = np.stack([np.zeros(t2, np.float32) if c.C is None
                  else c.C.astype(np.float32) for c in costs])
    args = (np.stack([c.S for c in costs]), D,
            np.stack([c.A for c in costs]).astype(np.float32),
            np.stack([c.B for c in costs]).astype(np.float32), C)
    kw = dict(zero_head=bool(c0.ins_zero_head_q),
              zero_tail=bool(c0.ins_zero_tail_q),
              off=int(c0.ins_dist_offset),
              has_c=any(c.C is not None for c in costs), vec_d=vec_d,
              del_free=bool(vec_d and c0.del_align
                            in _DEL_FREE_OVERHANG_MODES))
    return args, kw


def forward_scores_batch(costs: list[DPCosts],
                         local: bool = False) -> np.ndarray:
    """Optimal global scores H[q1, t1] for a batch of same-shape cost
    models; bit-identical to dp_ref / dp_engine."""
    assert costs
    q2, t2 = costs[0].q_size, costs[0].t_size
    if q2 < 4 or t2 < 4:
        from . import dp_ref
        return np.stack([dp_ref.build_forward(c, 0, q2 - 1, 0, t2 - 1,
                                              local=local).H[q2 - 1, t2 - 1]
                         for c in costs])
    args, kw = pack_costs(costs)
    out = batch_scores(*(jnp.asarray(a) for a in args), jnp.uint32(0),
                       local=local, **kw)
    return np.asarray(out)
