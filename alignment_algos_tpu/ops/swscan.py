"""Library-screen local alignment engines: one query against B templates,
affine gaps, (B,) Smith-Waterman scores.

``sw_strip_scores`` is the GPU engine, a Pallas kernel compiled through
Triton.  Each program owns ``BB`` templates, one per thread, and sweeps
the query in strips of ``R`` rows.  Inside a strip the R rows advance as
a wavefront along the template: at step s, row r of the strip updates
column j = s - r, so the R cells of a step are independent and their
dependency chains interleave (the instruction-level parallelism a warp
needs, since a 5,120-template library gives only 160 warps).  Each cell
is the Gotoh recurrence in exactly the operation order of
``swaffine.sw_affine_scores_xla``:

    E = max(E_left - ge, H_left - gi)
    F = max(F_up - ge, H_up - gi)
    H = max(max(H_diag + s, 0), max(E, F))

so its scores are bit-identical to that engine for any table (no
multiplication, nothing to contract or reassociate).  The similarity is
gathered in-kernel from the query's profile rows (``table[q_codes]``)
and the template codes: the (Q, T, B) similarity never exists in HBM.
Row values pass from row r to row r + 1 in registers; only the strip's
last row goes to memory (one (T, BB) H row and F row per program, read
back by the next strip).  Global loads for the next step and the
gathers of rows 1..R-1 are issued one step ahead.

Boundaries cost no masks: columns left of the template and right of it
carry a ``WALL`` similarity, and padded query rows a zero similarity.
Neither can raise the running maximum (a wall cell is at most
max(0, E, F), which only decay from real cells; a zero row only copies a
diagonal), provided gi >= 0 and ge >= 0 — the gate in ``supported``.

``sw_rowscan_scores_xla`` is the plain version of the same screen in
``lax``: a scan over query rows with the template-axis E recurrence
unrolled to a prefix max,

    E[i,j] = max_{k<j} (H~[i,k] - gi - ge*(j-1-k))
           = cummax_j(H~[i,k] + ge*k - gi)[j-1] - ge*(j-1)

(H~ = max(0, diag + s, F): by the gi >= ge lemma E never feeds itself
through H).  It reorders float operations, so it is exact only for
integer costs (every H value an exact float32 integer); it is the
kernel's CPU reference and the XLA version it was timed against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG = -3.0e38
WALL = -1.0e30      # similarity of the columns around each template
R = 32              # query rows per strip (independent chains per step)
BB = 32             # templates per program: one warp, one per thread


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def supported(gi: float, ge: float) -> bool:
    """Gate of the strip kernel: non-negative gap costs (the wall and
    zero-row padding argument above)."""
    return float(gi) >= 0.0 and float(ge) >= 0.0


def _strip_kernel(gap_ref, qprof_ref, tc_ref, out_ref, hrow_ref, frow_ref,
                  *, nstrips: int, t: int, a1: int):
    gi = gap_ref[0]
    ge = gap_ref[1]
    bb = out_ref.shape[0]
    zero = jnp.zeros((bb,), jnp.float32)
    neg = jnp.full((bb,), NEG, jnp.float32)
    pad = jnp.full((bb,), a1 - 1, jnp.int32)     # the wall code

    # the strip boundary rows: H and F of the previous strip's last row,
    # column j at index j + R - 1 (the first R - 1 slots take the wall
    # columns of the last row and are never read)
    def init(j, c):
        hrow_ref[j, :] = zero
        frow_ref[j, :] = neg
        return c
    lax.fori_loop(0, t + 2 * R + 1, init, 0)

    def strip(p, m):
        base = p * (R * a1)

        def step(s, carry):
            e, dg, h, f, code, sims, nxt, m = carry
            c0, hup, fup = nxt
            nxt = (tc_ref[s + 1, :], hrow_ref[s + R, :], frow_ref[s + R, :])
            ne, nd, nh, nf, nc = [], [], [], [], []
            for k in range(R):
                ck = c0 if k == 0 else code[k - 1]
                sim = qprof_ref[base + ck] if k == 0 else sims[k - 1]
                fk = jnp.maximum(fup - ge, hup - gi)
                ek = jnp.maximum(e[k] - ge, h[k] - gi)
                hk = jnp.maximum(jnp.maximum(dg[k] + sim, 0.0),
                                 jnp.maximum(ek, fk))
                m = jnp.maximum(m, hk)
                nd.append(hup)
                ne.append(ek)
                nh.append(hk)
                nf.append(fk)
                nc.append(ck)
                hup, fup = h[k], f[k]
            sims = tuple(qprof_ref[base + k * a1 + nc[k - 1]]
                         for k in range(1, R))
            hrow_ref[s, :] = nh[-1]
            frow_ref[s, :] = nf[-1]
            return (tuple(ne), tuple(nd), tuple(nh), tuple(nf), tuple(nc),
                    sims, nxt, m)

        sims0 = tuple(qprof_ref[base + k * a1 + pad] for k in range(1, R))
        nxt0 = (tc_ref[0, :], hrow_ref[R - 1, :], frow_ref[R - 1, :])
        carry = ((neg,) * R, (zero,) * R, (zero,) * R, (neg,) * R,
                 (pad,) * R, sims0, nxt0, m)
        return lax.fori_loop(0, t + R - 1, step, carry)[-1]

    out_ref[:] = lax.fori_loop(0, nstrips, strip, zero)


@functools.partial(jax.jit, static_argnames=("interpret",))
def sw_strip_scores(q_codes: jax.Array, t_codes: jax.Array,
                    table: jax.Array, gap: jax.Array, *,
                    interpret: bool = False) -> jax.Array:
    """q_codes (Q,) and t_codes (B, T) int codes into ``table`` (A, A);
    gap (1, 2) [gi, ge] with gi, ge >= 0.  Returns (B,) local SW scores,
    bit-identical to ``swaffine.sw_affine_scores_xla``.  ``interpret``
    runs the kernel in the Pallas interpreter (CPU tests)."""
    (q,) = q_codes.shape
    b, t = t_codes.shape
    a = table.shape[0]
    qp = _round_up(q, R)
    bp = _round_up(b, BB)
    qprof = jnp.zeros((qp, a + 1), jnp.float32)
    qprof = qprof.at[:q, :a].set(table.astype(jnp.float32)[q_codes])
    qprof = qprof.at[:, a].set(WALL)
    tc = jnp.full((t + R + 1, bp), a, jnp.int32)
    tc = tc.at[:t, :b].set(t_codes.T.astype(jnp.int32))
    kernel = functools.partial(_strip_kernel, nstrips=qp // R, t=t, a1=a + 1)
    rows = t + 2 * R + 1
    out, _, _ = pl.pallas_call(
        kernel,
        grid=(bp // BB,),
        in_specs=[pl.BlockSpec((2,), lambda i: (0,)),
                  pl.BlockSpec((qp * (a + 1),), lambda i: (0,)),
                  pl.BlockSpec((t + R + 1, BB), lambda i: (0, i))],
        out_specs=[pl.BlockSpec((BB,), lambda i: (i,)),
                   pl.BlockSpec((rows, BB), lambda i: (0, i)),
                   pl.BlockSpec((rows, BB), lambda i: (0, i))],
        out_shape=[jax.ShapeDtypeStruct((bp,), jnp.float32),
                   jax.ShapeDtypeStruct((rows, bp), jnp.float32),
                   jax.ShapeDtypeStruct((rows, bp), jnp.float32)],
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="sw_strip_scores",
    )(gap.reshape(2).astype(jnp.float32), qprof.reshape(-1), tc)
    return out[:b]


@jax.jit
def sw_rowscan_scores_xla(q_codes: jax.Array, t_codes: jax.Array,
                          table: jax.Array, gap: jax.Array) -> jax.Array:
    """Plain ``lax`` row scan (see module docstring).  Exact only for
    integer costs with gi >= ge >= 0 and every H value below 2^24; same
    arguments and result as ``sw_strip_scores`` then."""
    gi = gap[0, 0]
    ge = gap[0, 1]
    tct = t_codes.T                                   # (T, B)
    jj = jnp.arange(tct.shape[0], dtype=jnp.float32)[:, None]

    def row(carry, qrow):
        hp, f, m = carry
        s = qrow[tct]
        f = jnp.maximum(f - ge, hp - gi)
        diag = jnp.concatenate([jnp.zeros_like(hp[:1]), hp[:-1]])
        ht = jnp.maximum(jnp.maximum(diag + s, 0.0), f)
        cm = lax.cummax(ht + ge * jj - gi, axis=0)
        e = jnp.concatenate([jnp.full_like(cm[:1], NEG),
                             cm[:-1] - ge * (jj[1:] - 1.0)])
        h = jnp.maximum(ht, e)
        return (h, f, jnp.maximum(m, h)), None

    z = jnp.zeros(tct.shape, jnp.float32)
    (_, _, m), _ = lax.scan(row, (z, jnp.full_like(z, NEG), z),
                            table.astype(jnp.float32)[q_codes])
    return jnp.max(m, axis=0)

