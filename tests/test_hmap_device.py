"""Device-side HMAP similarity producer parity (ops/hmap_device).

The producer must rebuild HMAPaliEval.build_costs's z-normalized,
shifted similarity BIT-IDENTICALLY on device from per-sequence payloads
(no Q*T host->device transfer).  These tests run on the CPU backend —
the producer is backend-independent integer/f32 arithmetic; the GPU runs
the same checks in tests/test_gpu.py and chip_smoke.py."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from alignment_algos_tpu.ops import hmap_device
from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
from alignment_algos_tpu.seq.hmap import HMAPSequence
from alignment_algos_tpu.utils.params import HMAPaliParams

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)


def _profiles(rng, n, length):
    from make_profiles import make_profile
    seqs = []
    for i in range(n):
        import io
        seqs.append(HMAPSequence.from_stream(
            io.StringIO(make_profile(rng, f"s{i}", length))))
    return seqs


@pytest.mark.parametrize("length,n", [(30, 5), (61, 3)])
def test_similarity_bitparity(length, n):
    rng = np.random.default_rng(7)
    params = HMAPaliParams()
    ev = HMAPaliEval(params)
    seqs = _profiles(rng, n + 1, length)
    query, templates = seqs[0], seqs[1:]

    qp = hmap_device.pack_sequence(query)
    lib = hmap_device.DeviceLibrary(templates, ev)
    (t2, b), = lib.buckets.items()
    S_dev = np.asarray(hmap_device.build_similarity_device(
        jnp.asarray(qp["aa"]), jnp.asarray(qp["zsse"]),
        jnp.asarray(qp["conf"]), b["aa"], b["zsse"], b["conf"],
        jnp.float32(np.float32(params.alpha)),
        jnp.float32(np.float32(-np.float32(params.zero_shift))),
        jnp.uint32(0),
        q2=query.size(), t2=t2, normalize=bool(params.normalize_mtx)))

    for i, t in enumerate(templates):
        S_host = ev.build_costs(query, t).S
        same = S_dev[i].view(np.uint32) == S_host.view(np.uint32)
        if not same.all():
            bad = np.argwhere(~same)[:5]
            for r, c in bad:
                print(f"t{i} S[{r},{c}]: dev {S_dev[i][r, c]!r} "
                      f"host {S_host[r, c]!r}")
        assert same.all(), f"template {i}: {int((~same).sum())} bit diffs"


def test_similarity_no_normalize():
    rng = np.random.default_rng(8)
    params = HMAPaliParams()
    params.normalize_mtx = False
    ev = HMAPaliEval(params)
    seqs = _profiles(rng, 3, 24)
    query, templates = seqs[0], seqs[1:]
    qp = hmap_device.pack_sequence(query)
    lib = hmap_device.DeviceLibrary(templates, ev)
    (t2, b), = lib.buckets.items()
    S_dev = np.asarray(hmap_device.build_similarity_device(
        jnp.asarray(qp["aa"]), jnp.asarray(qp["zsse"]),
        jnp.asarray(qp["conf"]), b["aa"], b["zsse"], b["conf"],
        jnp.float32(np.float32(params.alpha)),
        jnp.float32(np.float32(-np.float32(params.zero_shift))),
        jnp.uint32(0),
        q2=query.size(), t2=t2, normalize=False))
    for i, t in enumerate(templates):
        S_host = ev.build_costs(query, t).S
        assert (S_dev[i].view(np.uint32) == S_host.view(np.uint32)).all()


def test_screen_scores_match_host_path():
    """End-to-end: device-produced S through the exact engine equals the
    host screen_profiles scores bitwise."""
    from alignment_algos_tpu.parallel.screen import screen_profiles

    rng = np.random.default_rng(9)
    params = HMAPaliParams()
    seqs = _profiles(rng, 7, 30)
    query, templates = seqs[0], seqs[1:]

    host_scores, host_order = screen_profiles(
        query, templates, lambda q, t: HMAPaliEval(params), k=4,
        engine="host")
    dev_scores, dev_order = hmap_device.screen_hmap_device(
        query, templates, params, k=4)
    assert (dev_scores.view(np.uint32)
            == host_scores.astype(np.float32).view(np.uint32)).all()
    assert (dev_order == host_order).all()


def test_mixed_lengths_bucketing():
    rng = np.random.default_rng(10)
    params = HMAPaliParams()
    q = _profiles(rng, 1, 40)[0]
    ts = _profiles(rng, 2, 28) + _profiles(rng, 2, 44) \
        + _profiles(rng, 1, 28)
    from alignment_algos_tpu.parallel.screen import screen_profiles
    host_scores, _ = screen_profiles(q, ts, lambda a, b: HMAPaliEval(params),
                                     k=5, engine="host")
    dev_scores, _ = hmap_device.screen_hmap_device(q, ts, params, k=5)
    assert (dev_scores.view(np.uint32)
            == host_scores.astype(np.float32).view(np.uint32)).all()


def test_hmap2_smap_screen_parity():
    """The HMAP2 structure-template path (Hmap2Eval over SMAPSequence —
    the nalign2 scoring form) must route through the device producer with
    bit-identical scores; Gn2Eval (its own similarity model) must NOT."""
    from alignment_algos_tpu.parallel.screen import screen_profiles
    from alignment_algos_tpu.scoring.gn2_eval import Gn2Params
    from alignment_algos_tpu.scoring.hmap2_eval import Hmap2Eval
    from alignment_algos_tpu.structure.smap import SMAPSequence

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    templ = SMAPSequence.from_file(os.path.join(data, "templ_smap.prof"),
                                   gn2=True)
    query = HMAPSequence.from_file(os.path.join(data, "query30.prof"))
    params = Gn2Params()
    host_scores, host_order = screen_profiles(
        query, [templ, templ], lambda q, t: Hmap2Eval(params), k=2,
        engine="host")
    dev_scores, dev_order = hmap_device.screen_hmap_device(
        query, [templ, templ], params, k=2,
        ev=Hmap2Eval(params))
    assert (dev_scores.view(np.uint32)
            == host_scores.astype(np.float32).view(np.uint32)).all()
    assert (dev_order == host_order).all()
