"""Batched affine SW engines (ops/swaffine): the anti-diagonal scores
scan, its traceback twin and their decoders, against the numpy Gotoh
oracle."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from alignment_algos_tpu.ops import swaffine


def test_skew_layout():
    rng = np.random.default_rng(0)
    s = rng.standard_normal((2, 5, 7)).astype(np.float32)
    sd = np.asarray(swaffine.skew_similarity(jnp.asarray(s)))
    assert sd.shape == (11, 8, 128)
    for bi in range(2):
        for i in range(5):
            for j in range(7):
                assert sd[i + j, i, bi] == s[bi, i, j]


@pytest.mark.parametrize("q,t,seed", [(8, 8, 0), (13, 10, 1)])
def test_sw_scores_match_gotoh_oracle(q, t, seed):
    rng = np.random.default_rng(seed)
    b = 4
    s = rng.integers(-4, 12, size=(b, q, t)).astype(np.float32)
    gi, ge = 11.0, 1.0
    ref = swaffine.sw_affine_reference(s, gi, ge)

    sd = swaffine.skew_similarity(jnp.asarray(s))
    gap = jnp.array([[gi, ge]], dtype=jnp.float32)
    xla = swaffine.sw_affine_scores_xla(sd, gap, q=q, t=t)
    np.testing.assert_allclose(np.asarray(xla)[:b], ref, rtol=0, atol=0)


def test_sw_matches_general_dp_local():
    """Gotoh optimum equals the reference general-gap local DP optimum for
    affine costs."""
    from alignment_algos_tpu.ops import dp_ref
    from alignment_algos_tpu.scoring.base import DPCosts, affine_deletion_table
    from alignment_algos_tpu.utils.params import AlignT
    from alignment_algos_tpu.core.enumerators.optimal import Optimal

    rng = np.random.default_rng(3)
    q, t = 12, 14
    sim = rng.integers(-4, 10, size=(q, t)).astype(np.float32)
    gi, ge = 5.0, 0.5
    ref = swaffine.sw_affine_reference(sim[None], gi, ge)[0]

    # wrap sim into sentinel-bordered costs with LOCAL overhang rules
    S = np.zeros((q + 2, t + 2), np.float32)
    S[1:-1, 1:-1] = sim
    givec = np.full((t + 2, t + 2), np.float32(gi))
    gevec = np.full((t + 2, t + 2), np.float32(ge))
    D = affine_deletion_table(givec, gevec, AlignT.LOCAL)
    A = np.full(t + 2, np.float32(gi))
    B = np.full(t + 2, np.float32(ge))
    c = DPCosts(S=S, D=D, A=A, B=B, ins_zero_head_q=True, ins_zero_tail_q=True)
    res = dp_ref.build_forward(c, 0, q + 1, 0, t + 1, local=True)

    class FakeDPM:
        def __init__(self):
            self.res = res

        def get_query_size(self):
            return q + 2

        def get_template_size(self):
            return t + 2

        def score(self, i, j):
            return float(res.H[i, j])

        def prev(self, i, j):
            return int(res.PQ[i, j]), int(res.PT[i, j])

    qm, tm, local_max = Optimal._find_max(FakeDPM())
    np.testing.assert_allclose(local_max, ref, rtol=1e-6)


def test_fused_skew_matches_two_pass():
    """Batch-last fused skew == similarity_from_codes + skew_similarity."""
    rng = np.random.default_rng(7)
    b, q, t = 5, 9, 12
    qc = jnp.asarray(rng.integers(0, 20, (b, q)), jnp.int32)
    tc = jnp.asarray(rng.integers(0, 20, (b, t)), jnp.int32)
    table = jnp.asarray(rng.integers(-4, 12, (20, 20)).astype(np.float32))
    ref = np.asarray(swaffine.skew_similarity(
        swaffine.similarity_from_codes(qc, tc, table)))
    fused = np.asarray(swaffine.skewed_similarity_from_codes(qc, tc, table))
    np.testing.assert_array_equal(fused, ref)


def test_int8_similarity_exact_for_integer_tables():
    rng = np.random.default_rng(8)
    b, q, t = 4, 16, 16
    qc = jnp.asarray(rng.integers(0, 20, (b, q)), jnp.int32)
    tc = jnp.asarray(rng.integers(0, 20, (b, t)), jnp.int32)
    table = jnp.asarray(rng.integers(-8, 12, (20, 20)).astype(np.float32))
    gi, ge = 11.0, 1.0
    f32 = np.asarray(swaffine.sw_affine_batch_xla(qc, tc, table, gi, ge))
    sd8 = swaffine.skewed_similarity_from_codes(qc, tc, table,
                                                sim_dtype=jnp.int8)
    assert sd8.dtype == jnp.int8
    gap = jnp.array([[gi, ge]], dtype=jnp.float32)
    i8 = np.asarray(swaffine.sw_affine_scores_xla(sd8, gap, q=q, t=t))[:b]
    np.testing.assert_array_equal(i8, f32)


def _path_score(s, pairs, gi, ge):
    """Recompute a local alignment's score from its matched pairs (between
    consecutive matches at most one template-gap run and one query-gap run
    exist in a Gotoh path; costs are affine in each run's length)."""
    total = 0.0
    prev = None
    for (i, j) in pairs:
        total += float(s[i, j])
        if prev is not None:
            di, dj = i - prev[0], j - prev[1]
            assert di >= 1 and dj >= 1
            if dj > 1:
                total -= gi + ge * (dj - 2)
            if di > 1:
                total -= gi + ge * (di - 2)
        prev = (i, j)
    return np.float32(total)


@pytest.mark.parametrize("q,t,seed", [(8, 8, 0), (13, 10, 1), (24, 17, 2)])
def test_sw_traceback_kernel_decodes_optimal_paths(q, t, seed):
    rng = np.random.default_rng(seed)
    b = 4
    s = rng.integers(-4, 12, size=(b, q, t)).astype(np.float32)
    gi, ge = 11.0, 1.0
    ref = swaffine.sw_affine_reference(s, gi, ge)

    sd = swaffine.skew_similarity(jnp.asarray(s))
    gap = jnp.array([[gi, ge]], dtype=jnp.float32)
    tb, m, dat = swaffine.sw_affine_tb_xla(sd, gap, q=q, t=t)
    scores, paths = swaffine.decode_local_tracebacks(
        np.asarray(tb), np.asarray(m), np.asarray(dat), q, t, nb=b)
    np.testing.assert_allclose(scores, ref, rtol=0, atol=0)
    for bi in range(b):
        if ref[bi] == 0.0:
            assert paths[bi] == []
            continue
        assert len(paths[bi]) >= 1
        # strictly increasing, in bounds
        pi, pj = zip(*paths[bi])
        assert all(x2 > x1 for x1, x2 in zip(pi, pi[1:]))
        assert all(x2 > x1 for x1, x2 in zip(pj, pj[1:]))
        assert min(pi) >= 0 and max(pi) < q and min(pj) >= 0 and max(pj) < t
        np.testing.assert_allclose(_path_score(s[bi], paths[bi], gi, ge),
                                   ref[bi], rtol=0, atol=0)


def test_sw_traceback_zero_score_lane():
    # all-negative similarity: best local score is 0 (empty alignment)
    q = t = 6
    s = np.full((1, q, t), -5.0, np.float32)
    sd = swaffine.skew_similarity(jnp.asarray(s))
    gap = jnp.array([[4.0, 0.5]], dtype=jnp.float32)
    tb, m, dat = swaffine.sw_affine_tb_xla(sd, gap, q=q, t=t)
    scores, paths = swaffine.decode_local_tracebacks(
        np.asarray(tb), np.asarray(m), np.asarray(dat), q, t, nb=1)
    assert scores[0] == 0.0 and paths[0] == []


@pytest.mark.parametrize("q,t,seed", [(8, 8, 3), (13, 10, 4), (24, 17, 5)])
def test_sw_tb_xla_matches_scores_engine(q, t, seed):
    """The traceback engine's running max equals the scores engine
    bitwise, on a fractional table, and its diagonal-of-max points at a
    cell that holds that max."""
    rng = np.random.default_rng(seed)
    b = 4
    s = rng.normal(1.0, 3.0, size=(b, q, t)).astype(np.float32)
    gap = jnp.array([[4.73, 0.34]], dtype=jnp.float32)
    sd = swaffine.skew_similarity(jnp.asarray(s))
    tb, m, dat = swaffine.sw_affine_tb_xla(sd, gap, q=q, t=t)
    scores = np.asarray(swaffine.sw_affine_scores_xla(sd, gap, q=q, t=t))
    m = np.asarray(m)
    np.testing.assert_array_equal(m.max(axis=0)[:b].view(np.uint32),
                                  scores[:b].view(np.uint32))
    got, _ = swaffine.decode_local_tracebacks(np.asarray(tb), m,
                                              np.asarray(dat), q, t, nb=b)
    np.testing.assert_array_equal(got, scores[:b])
    np.testing.assert_array_equal(
        got, swaffine.sw_affine_reference(s, 4.73, 0.34))


def test_sw_tb_batch_end_to_end():
    """codes -> traceback -> decoded paths: scores match the score-only
    engine and every path re-scores to its reported score."""
    rng = np.random.default_rng(7)
    b, q, t = 5, 16, 19
    qc = rng.integers(0, 20, (b, q)).astype(np.int32)
    tc = rng.integers(0, 20, (b, t)).astype(np.int32)
    table = rng.integers(-6, 8, (20, 20)).astype(np.float32)
    gi, ge = 5.0, 0.5
    scores, paths = swaffine.sw_affine_tb_batch(qc, tc, table, gi, ge)
    ref = np.asarray(swaffine.sw_affine_batch_xla(qc, tc, table, gi, ge))
    np.testing.assert_allclose(scores, ref, rtol=0, atol=0)
    for bi in range(b):
        if scores[bi] == 0.0:
            assert paths[bi] == []
            continue
        s = table[np.ix_(qc[bi], tc[bi])]
        np.testing.assert_allclose(_path_score(s, paths[bi], gi, ge),
                                   scores[bi], rtol=0, atol=0)


def test_device_decode_matches_host():
    """decode_local_tracebacks_device (fori_loop on-device port) must
    produce identical scores and paths to the host decode."""
    rng = np.random.default_rng(21)
    b, q, t = 9, 40, 33
    qc = jnp.asarray(rng.integers(0, 20, (b, q)), jnp.int32)
    tc = jnp.asarray(rng.integers(0, 20, (b, t)), jnp.int32)
    table = jnp.asarray(rng.integers(-4, 12, (20, 20)).astype(np.float32))
    gap = jnp.array([[11.0, 1.0]], dtype=jnp.float32)
    sd = swaffine.skewed_similarity_from_codes(qc, tc, table)
    tb, m, dat = swaffine.sw_affine_tb_xla(sd, gap, q=q, t=t)
    s_host, p_host = swaffine.decode_local_tracebacks(
        np.asarray(tb), np.asarray(m), np.asarray(dat), q, t, nb=b)
    s_dev, p_dev = swaffine.decode_local_tracebacks_device(tb, m, dat,
                                                           q, t, nb=b)
    np.testing.assert_array_equal(s_dev, s_host)
    assert p_dev == p_host
