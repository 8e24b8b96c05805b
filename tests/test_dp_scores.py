"""Batched exact general-gap scores engine (ops/dp_scores): bit parity
with the numpy oracle engine, with the deletion table shipped whole or
rebuilt on device from its gap vectors.  On the GPU the same comparison
runs at 258/514/700 in tests/test_gpu.py and chip_smoke.py."""

import os

import numpy as np
import pytest

from alignment_algos_tpu.ops import dp_ref, dp_scores
from alignment_algos_tpu.scoring.base import DPCosts
from alignment_algos_tpu.utils.params import AlignT

from util import random_costs

CASES = [
    (8, 9, AlignT.GLOBAL, False, False),
    (9, 7, AlignT.SEMI_LOCAL, True, False),
    (10, 10, AlignT.GLOBAL, False, True),
    (14, 11, AlignT.GLOBAL_LOCAL, True, False),
    (7, 13, AlignT.LOCAL, True, True),
    (33, 18, AlignT.GLOBAL, False, False),
    (12, 17, AlignT.LOCAL_GLOBAL, False, False),
]


def _refs(costs, local=False):
    return np.array([dp_ref.build_forward(
        c, 0, c.q_size - 1, 0, c.t_size - 1, local=local).H[-1, -1]
        for c in costs], np.float32)


def _assert_bits(got, ref):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.uint32),
                                  ref.view(np.uint32))


@pytest.mark.parametrize("vectors", [False, True])
@pytest.mark.parametrize("q2,t2,atype,zf,local", CASES)
def test_scores_match_oracle(q2, t2, atype, zf, local, vectors):
    rng = np.random.default_rng(q2 * 1000 + t2)
    c = random_costs(rng, q2, t2, atype, zf, vectors=vectors)
    got = dp_scores.forward_scores_batch([c], local=local)
    _assert_bits(got, _refs([c], local))


def test_scores_batched_cross_group():
    """A batch of distinct pairs: every lane scores its own pair."""
    rng = np.random.default_rng(42)
    costs = [random_costs(rng, 12, 15, AlignT.GLOBAL, False, vectors=True)
             for _ in range(10)]
    _assert_bits(dp_scores.forward_scores_batch(costs), _refs(costs))


def test_scores_with_c_column_and_offset():
    """gn2-style generalized insertion: extra C[j] term and dist offset."""
    rng = np.random.default_rng(7)
    c = random_costs(rng, 13, 12, AlignT.GLOBAL, False)
    c2 = DPCosts(S=c.S, D=c.D, A=c.A, B=c.B,
                 ins_zero_head_q=False, ins_zero_tail_q=False,
                 C=rng.normal(0, 1, c.t_size).astype(np.float32),
                 ins_dist_offset=1)
    _assert_bits(dp_scores.forward_scores_batch([c2]), _refs([c2]))


def test_scores_hmap_cost_model():
    """Flagship path: HMAP profile-profile cost models through the
    engine, scores bit-equal to the full DPMatrix build."""
    from alignment_algos_tpu.core.dp import DPMatrix
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.utils.params import HMAPaliParams

    data = os.path.join(os.path.dirname(__file__), "golden", "inputs")
    query = HMAPSequence.from_file(os.path.join(data, "qA.prof"))
    templ = HMAPSequence.from_file(os.path.join(data, "tA.prof"))
    params = HMAPaliParams()
    c = HMAPaliEval(params).build_costs(query, templ)
    dpm = DPMatrix(query, templ, HMAPaliEval(params), "fwd",
                   params.align_type)
    _assert_bits(dp_scores.forward_scores_batch([c]),
                 np.array([dpm.res.H[-1, -1]], np.float32))


def test_tiny_shapes_fall_back():
    rng = np.random.default_rng(3)
    c = random_costs(rng, 3, 3, AlignT.GLOBAL, False)
    _assert_bits(dp_scores.forward_scores_batch([c]), _refs([c]))


def test_mixed_shapes_rejected():
    rng = np.random.default_rng(4)
    costs = [random_costs(rng, 9, 9), random_costs(rng, 9, 10)]
    with pytest.raises(AssertionError, match="bucket by shape"):
        dp_scores.forward_scores_batch(costs)
