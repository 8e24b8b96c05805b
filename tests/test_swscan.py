"""Library-screen engines of ops/swscan against the Gotoh references: the
Triton strip kernel in the Pallas interpreter (any table, bit-equal to
swaffine.sw_affine_scores_xla) and the plain lax row scan (integer
tables).  On the GPU the compiled kernel runs the same comparisons in
tests/test_gpu.py and chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp

from alignment_algos_tpu.ops import swaffine, swscan


def _engine(name):
    if name == "strip":
        return lambda qc, tc, tbl, gap: swscan.sw_strip_scores(
            qc, tc, tbl, gap, interpret=True)
    return swscan.sw_rowscan_scores_xla


def _diag_scores(qc, tc, table, gap):
    """One query against a library through the anti-diagonal engine."""
    b, t = tc.shape
    q = qc.shape[0]
    sd = swaffine.skewed_similarity_from_codes(
        jnp.broadcast_to(jnp.asarray(qc)[None], (b, q)), jnp.asarray(tc),
        jnp.asarray(table))
    return np.asarray(swaffine.sw_affine_scores_xla(sd, gap, q=q, t=t))[:b]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("engine", ["strip", "rowscan"])
@pytest.mark.parametrize("q,t,b,seed", [
    (32, 32, 5, 0),
    (40, 24, 3, 1),      # query rows beyond one strip
    (16, 48, 4, 2),
    (13, 29, 2, 3),      # tiny odd shapes
    (70, 9, 33, 4),      # more templates than one program
])
def test_rowscan_bit_equal_gotoh(engine, q, t, b, seed):
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, 20, q).astype(np.int32)
    tc = rng.integers(0, 20, (b, t)).astype(np.int32)
    table = rng.integers(-6, 12, (20, 20)).astype(np.float32)
    gap = jnp.array([[11.0, 1.0]], jnp.float32)
    got = np.asarray(_engine(engine)(qc, tc, table, gap))
    np.testing.assert_array_equal(_bits(got), _bits(_diag_scores(
        qc, tc, table, gap)))
    s = table[qc][:, tc].transpose(1, 0, 2)          # (B, Q, T)
    np.testing.assert_array_equal(
        got, swaffine.sw_affine_reference(s, 11.0, 1.0))


def test_rowscan_screen_shape_bit_equal():
    """One query against a library equals the distinct-pairs engine on
    the broadcast query."""
    rng = np.random.default_rng(7)
    q, t, nlib = 24, 40, 6
    qc = rng.integers(0, 20, q).astype(np.int32)
    lib = rng.integers(0, 20, (nlib, t)).astype(np.int32)
    table = rng.integers(-6, 12, (20, 20)).astype(np.float32)
    gi, ge = 8.0, 2.0
    ref = np.asarray(swaffine.sw_affine_batch_xla(
        np.broadcast_to(qc, (nlib, q)), lib, table, gi, ge))
    got = np.asarray(swscan.sw_strip_scores(
        qc, lib, table, jnp.array([[gi, ge]], jnp.float32), interpret=True))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("gi,ge,seed", [(4.73, 0.34, 0), (2.5, 2.5, 1),
                                        (0.3, 0.0, 2)])
def test_strip_fractional_table_bit_equal(gi, ge, seed):
    """The strip kernel repeats the anti-diagonal engine's operations
    cell for cell, so it is bit-equal for fractional tables too."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, 20, 37).astype(np.int32)
    tc = rng.integers(0, 20, (9, 31)).astype(np.int32)
    table = rng.normal(0.5, 2.0, (20, 20)).astype(np.float32)
    gap = jnp.array([[gi, ge]], jnp.float32)
    got = swscan.sw_strip_scores(qc, tc, table, gap, interpret=True)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_diag_scores(qc, tc, table, gap)))


def test_strip_padded_library_wall():
    """Templates padded with a wall code (the screen CLI's encoding) score
    as their unpadded selves."""
    from alignment_algos_tpu.cli.screen import PAD_WALL
    rng = np.random.default_rng(5)
    table = np.full((21, 21), PAD_WALL, np.float32)
    table[:20, :20] = rng.integers(-4, 11, (20, 20))
    qc = rng.integers(0, 20, 30).astype(np.int32)
    tc = rng.integers(0, 20, (4, 26)).astype(np.int32)
    padded = np.full((4, 40), 20, np.int32)
    padded[:, :26] = tc
    gap = jnp.array([[11.0, 1.0]], jnp.float32)
    got = swscan.sw_strip_scores(qc, padded, table, gap, interpret=True)
    ref = swscan.sw_strip_scores(qc, tc, table, gap, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_supported_gate():
    assert swscan.supported(11.0, 1.0)
    assert swscan.supported(4.73, 0.34)       # fractional gaps are fine
    assert swscan.supported(0.0, 0.0)
    assert not swscan.supported(-1.0, 1.0)    # the wall argument needs
    assert not swscan.supported(1.0, -0.5)    # non-negative gaps


@pytest.mark.parametrize("engine", ["strip", "rowscan"])
def test_rowscan_gi_equals_ge_boundary(engine):
    """The prefix-max lemma requires gi >= ge; equality is the boundary
    case (E - gi == E - ge) and must stay bit-equal."""
    rng = np.random.default_rng(31)
    qc = rng.integers(0, 20, 24).astype(np.int32)
    tc = rng.integers(0, 20, (3, 40)).astype(np.int32)
    table = rng.integers(-6, 12, (20, 20)).astype(np.float32)
    gap = jnp.array([[3.0, 3.0]], jnp.float32)
    got = np.asarray(_engine(engine)(qc, tc, table, gap))
    np.testing.assert_array_equal(got, _diag_scores(qc, tc, table, gap))
