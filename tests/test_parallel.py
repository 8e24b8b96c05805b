"""Sharded library screen on the virtual 8-device CPU mesh: results must be
identical to the single-device reference (deterministic top-K merge)."""

import numpy as np
import pytest

import jax

from alignment_algos_tpu.parallel.screen import (default_mesh, screen_library,
                                                 screen_library_host)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, 48).astype(np.int32)
    lib = rng.integers(0, 20, (37, 56)).astype(np.int32)  # non-divisible count
    table = rng.integers(-4, 11, (20, 20)).astype(np.float32)
    return q, lib, table


def test_mesh_has_8_devices():
    mesh = default_mesh(8)
    assert mesh.devices.size == 8


def test_sharded_screen_matches_host(inputs):
    q, lib, table = inputs
    mesh = default_mesh(8)
    s_mesh, i_mesh = screen_library(q, lib, table, 11.0, 1.0, k=12, mesh=mesh)
    s_host, i_host = screen_library_host(q, lib, table, 11.0, 1.0, k=12)
    np.testing.assert_array_equal(i_mesh, i_host)
    np.testing.assert_allclose(s_mesh, s_host, rtol=0, atol=0)


def test_sharded_screen_deterministic_on_ties(inputs):
    q, lib, table = inputs
    # duplicate templates -> guaranteed score ties; lower index must win
    lib2 = np.concatenate([lib[:5], lib[:5], lib[5:]], axis=0)
    mesh = default_mesh(8)
    s, i = screen_library(q, lib2, table, 11.0, 1.0, k=10, mesh=mesh)
    s2, i2 = screen_library(q, lib2, table, 11.0, 1.0, k=10, mesh=mesh)
    np.testing.assert_array_equal(i, i2)
    # scores sorted descending
    assert (np.diff(s) <= 0).all()


def test_mesh_sizes_1_2_4(inputs):
    q, lib, table = inputs
    ref_s, ref_i = screen_library_host(q, lib, table, 11.0, 1.0, k=7)
    for n in (1, 2, 4):
        mesh = default_mesh(n)
        s, i = screen_library(q, lib, table, 11.0, 1.0, k=7, mesh=mesh)
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_allclose(s, ref_s, atol=0)


def test_batched_general_dp_matches_single():
    """The vmapped general-gap engine equals per-pair builds exactly."""
    from alignment_algos_tpu.ops import dp_engine, dp_ref
    from alignment_algos_tpu.utils.params import AlignT
    from util import random_costs

    rng = np.random.default_rng(9)
    batch = [random_costs(rng, 14, 12, AlignT.GLOBAL, False) for _ in range(5)]
    results = dp_engine.build_forward_jax_batched(batch)
    for c, res in zip(batch, results):
        ref = dp_ref.build_forward(c, 0, 13, 0, 11)
        np.testing.assert_array_equal(res.H, ref.H)
        np.testing.assert_array_equal(res.PQ, ref.PQ)
        np.testing.assert_array_equal(res.PT, ref.PT)


def test_profile_screen_exact_scoring():
    import os
    from alignment_algos_tpu.parallel.screen import screen_profiles
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.utils.params import HMAPaliParams
    from alignment_algos_tpu.core.dp import DPMatrix

    data = os.path.join(os.path.dirname(__file__), "golden", "inputs")
    query = HMAPSequence.from_file(os.path.join(data, "qA.prof"))
    lib = [HMAPSequence.from_file(os.path.join(data, n))
           for n in ("tA.prof", "tB.prof", "qB.prof")]
    params = HMAPaliParams()
    factory = lambda q, t: HMAPaliEval(params)
    scores, order = screen_profiles(query, lib, factory, k=3)
    # compare against individual DPMatrix builds
    for i, t in enumerate(lib):
        dpm = DPMatrix(query, t, HMAPaliEval(params), "fwd", params.align_type)
        assert np.float32(scores[i]) == np.float32(dpm.res.H[-1, -1])
    assert (np.diff(scores[order]) <= 0).all()


def test_screen_grid_2d_mesh(inputs):
    from alignment_algos_tpu.parallel.screen import grid_mesh, screen_grid
    q, lib, table = inputs
    qs = np.stack([q, (q + 1) % 20, (q + 5) % 20])
    mesh = grid_mesh((2, 4))
    scores, ts, ti = screen_grid(qs, lib, table, 11.0, 1.0, k=5, mesh=mesh)
    # per-query rows equal the 1-device host screen
    for r in range(qs.shape[0]):
        s_host, i_host = screen_library_host(qs[r], lib, table, 11.0, 1.0,
                                             k=5)
        np.testing.assert_array_equal(ti[r], i_host)
        np.testing.assert_allclose(ts[r], s_host, atol=0)


# ---------------------------------------------------------------------------
# checkpoint/resume (parallel/checkpoint.py)

def test_checkpointed_screen_matches_direct(inputs, tmp_path):
    from alignment_algos_tpu.parallel.checkpoint import (
        screen_library_checkpointed)
    q, lib, table = inputs
    mesh = default_mesh(8)
    ck = str(tmp_path / "screen.npz")
    s, i, done = screen_library_checkpointed(q, lib, table, 11.0, 1.0, k=12,
                                             chunk_size=10, ckpt_path=ck,
                                             mesh=mesh)
    assert done
    s_ref, i_ref = screen_library_host(q, lib, table, 11.0, 1.0, k=12)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(s, s_ref)


def test_checkpointed_screen_resumes(inputs, tmp_path):
    from alignment_algos_tpu.parallel import checkpoint as cp
    q, lib, table = inputs
    mesh = default_mesh(8)
    ck = str(tmp_path / "screen.npz")
    # simulate preemption after 2 of 4 chunks
    s, i, done = cp.screen_library_checkpointed(
        q, lib, table, 11.0, 1.0, k=12, chunk_size=10, ckpt_path=ck,
        mesh=mesh, max_chunks=2)
    assert not done
    # resume must process only the remaining chunks and finish
    calls = []
    orig = cp.screen_library

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    cp.screen_library, orig_ref = counting, cp.screen_library
    try:
        s2, i2, done2 = cp.screen_library_checkpointed(
            q, lib, table, 11.0, 1.0, k=12, chunk_size=10, ckpt_path=ck,
            mesh=mesh)
    finally:
        cp.screen_library = orig_ref
    assert done2 and len(calls) == 2  # 4 chunks total, 2 already done
    s_ref, i_ref = screen_library_host(q, lib, table, 11.0, 1.0, k=12)
    np.testing.assert_array_equal(i2, i_ref)
    np.testing.assert_array_equal(s2, s_ref)


def test_checkpoint_shape_mismatch_rejected(inputs, tmp_path):
    from alignment_algos_tpu.parallel.checkpoint import (
        screen_library_checkpointed)
    q, lib, table = inputs
    mesh = default_mesh(8)
    ck = str(tmp_path / "screen.npz")
    screen_library_checkpointed(q, lib, table, 11.0, 1.0, k=12,
                                chunk_size=10, ckpt_path=ck, mesh=mesh)
    with pytest.raises(ValueError, match="different screen shape"):
        screen_library_checkpointed(q, lib, table, 11.0, 1.0, k=12,
                                    chunk_size=5, ckpt_path=ck, mesh=mesh)


def test_profiling_helpers(tmp_path):
    from alignment_algos_tpu.utils import profiling
    # no-op path
    with profiling.maybe_trace() as d:
        assert d is None
    # real trace capture
    logdir = str(tmp_path / "trace")
    with profiling.maybe_trace(logdir):
        with profiling.annotate("region"):
            jax.jit(lambda x: x * 2)(np.ones(4)).block_until_ready()
    import os
    assert any("plugins" in r or f for r, _, f in os.walk(logdir))
    sw = profiling.Stopwatch()
    assert sw.cups(10_000) > 0 and profiling.cups(100, 0.0) == float("inf")


def test_profile_screen_sharded_bit_equal():
    """screen_profiles over the 8-device mesh == single-device, bitwise
    (profile mode; shard_map partitions only the bucket batch axis)."""
    import os
    from alignment_algos_tpu.parallel.screen import default_mesh, \
        screen_profiles
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.utils.params import HMAPaliParams

    data = os.path.join(os.path.dirname(__file__), "golden", "inputs")
    query = HMAPSequence.from_file(os.path.join(data, "qA.prof"))
    lib = [HMAPSequence.from_file(os.path.join(data, n))
           for n in ("tA.prof", "tB.prof", "qB.prof")]
    params = HMAPaliParams()
    factory = lambda q, t: HMAPaliEval(params)
    single_scores, single_order = screen_profiles(query, lib, factory, k=3)
    for ndev in (2, 8):
        mesh = default_mesh(ndev)
        scores, order = screen_profiles(query, lib, factory, k=3, mesh=mesh)
        np.testing.assert_array_equal(scores, single_scores)
        np.testing.assert_array_equal(order, single_order)


def test_smap_screen_sharded_bit_equal():
    """Fold-recognition (Gn2Eval SMAP) screen sharded == single, bitwise."""
    import os
    from alignment_algos_tpu.parallel.screen import default_mesh, \
        screen_profiles
    from alignment_algos_tpu.scoring.gn2_eval import Gn2Eval, Gn2Params
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.structure.smap import SMAPSequence

    data = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "tests", "data")
    query = HMAPSequence.from_file(os.path.join(data, "query30.prof"))
    templ = SMAPSequence.from_file(os.path.join(data, "templ_smap.prof"),
                                   gn2=True)
    lib = [templ, templ, templ]  # same-shape bucket of 3, sharded over 2
    params = Gn2Params()
    factory = lambda q, t: Gn2Eval(params)
    single_scores, _ = screen_profiles(query, lib, factory, k=3)
    mesh = default_mesh(2)
    scores, _ = screen_profiles(query, lib, factory, k=3, mesh=mesh)
    np.testing.assert_array_equal(scores, single_scores)


# ---------------------------------------------------------------------------
# meshes and the engine rule


def test_default_mesh_raises_on_too_few_devices():
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        default_mesh(16)


def test_grid_mesh_raises_on_too_few_devices():
    from alignment_algos_tpu.parallel.screen import grid_mesh
    with pytest.raises(ValueError, match="need 12 devices"):
        grid_mesh((3, 4))
    assert grid_mesh((2, 4)).devices.shape == (2, 4)


def test_engine_rule_keys_on_mesh_platform():
    from alignment_algos_tpu.parallel import screen as ps
    from alignment_algos_tpu.scoring.gn2_eval import Gn2Eval, Gn2Params
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.utils.params import HMAPaliParams

    cpu = default_mesh(2)
    assert not ps.on_gpu(cpu)
    assert ps.pick_engine(cpu, 11.0, 1.0) == "xla"
    assert ps.profile_engine(default_mesh(1),
                             HMAPaliEval(HMAPaliParams())) == "host"

    class FakeGpu:
        platform = "gpu"

    class FakeMesh:
        def __init__(self, n):
            self.devices = np.array([FakeGpu()] * n)

    assert ps.pick_engine(FakeMesh(1), 11.0, 1.0) == "triton"
    assert ps.pick_engine(FakeMesh(4), 4.73, 0.34) == "triton"
    assert ps.pick_engine(FakeMesh(1), -1.0, 1.0) == "xla"
    assert ps.profile_engine(FakeMesh(1),
                             HMAPaliEval(HMAPaliParams())) == "device"
    assert ps.profile_engine(FakeMesh(4),
                             HMAPaliEval(HMAPaliParams())) == "host"
    assert ps.profile_engine(FakeMesh(1), Gn2Eval(Gn2Params())) == "host"


def test_unknown_engines_rejected(inputs):
    from alignment_algos_tpu.parallel.screen import screen_profiles
    q, lib, table = inputs
    with pytest.raises(ValueError, match="unknown screen engine"):
        screen_library(q, lib, table, 11.0, 1.0, engine="pallas")
    with pytest.raises(ValueError, match="unknown profile engine"):
        screen_profiles(None, [None], lambda a, b: None, engine="pallas")


@pytest.mark.parametrize("ndev", [1, 4])
def test_sharded_strip_kernel_matches_host(inputs, ndev):
    """The GPU engine's sharded path (shard_map over the library, the
    Triton kernel per shard) rehearsed on virtual CPU devices with the
    kernel in the Pallas interpreter."""
    q, lib, table = inputs
    s, i = screen_library(q, lib, table, 11.0, 1.0, k=9,
                          mesh=default_mesh(ndev), engine="triton")
    s_host, i_host = screen_library_host(q, lib, table, 11.0, 1.0, k=9)
    np.testing.assert_array_equal(i, i_host)
    np.testing.assert_array_equal(s, s_host)


def test_screen_grid_strip_kernel_2x2(inputs):
    from alignment_algos_tpu.parallel.screen import grid_mesh, screen_grid
    q, lib, table = inputs
    qs = np.stack([q, (q + 3) % 20, (q + 7) % 20])
    sc, ts, ti = screen_grid(qs, lib, table, 11.0, 1.0, k=4,
                             mesh=grid_mesh((2, 2)), engine="triton")
    ref, _, _ = screen_grid(qs, lib, table, 11.0, 1.0, k=4,
                            mesh=grid_mesh((1, 1)), engine="xla")
    np.testing.assert_array_equal(sc, ref)
    for r in range(len(qs)):
        s_host, i_host = screen_library_host(qs[r], lib, table, 11.0, 1.0,
                                             k=4)
        np.testing.assert_array_equal(ti[r], i_host)
        np.testing.assert_array_equal(ts[r], s_host)
