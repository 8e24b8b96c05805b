"""Loose CPU-side performance floors.

The parity suites pin correctness but nothing pinned speed: a silent 2x
regression in a hot engine would pass every test.  These canaries assert
very loose floors (>= 4-6x below the measured typical rate on an idle
2-core host) so only a genuine order-of-magnitude regression trips them,
not machine load.  Measured typicals (2026-08, this host):
  - swaffine XLA twin, 32x256x256: ~0.07 GCUPS   (floor 0.01)
  - native cw enumeration, 512-pair @ NUM_SUBOPT=1000: ~20k ali/s
    (floor 1.5k)
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _best_of(f, n=3):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        f()
        times.append(time.perf_counter() - t0)
    return min(times)


def test_swaffine_xla_twin_floor():
    from alignment_algos_tpu.ops import swaffine

    rng = np.random.default_rng(0)
    B, Q, T = 32, 256, 256
    q = rng.integers(0, 20, (B, Q)).astype(np.int32)
    t = rng.integers(0, 20, (B, T)).astype(np.int32)
    tbl = rng.integers(-4, 12, (20, 20)).astype(np.float32)
    gap = jnp.array([[11.0, 1.0]], jnp.float32)
    s = swaffine.similarity_from_codes(jnp.asarray(q), jnp.asarray(t),
                                       jnp.asarray(tbl))
    sd = swaffine.skew_similarity(s)
    f = jax.jit(lambda x: swaffine.sw_affine_scores_xla(x, gap, q=Q, t=T))
    f(sd).block_until_ready()  # compile
    dt = _best_of(lambda: f(sd).block_until_ready())
    gcups = B * Q * T / dt / 1e9
    assert gcups > 0.01, f"XLA-twin SW rate regressed: {gcups:.4f} GCUPS"


def test_native_enum_floor():
    from alignment_algos_tpu.core.alignment import AlignmentSet
    from alignment_algos_tpu.core.dp import DPMatrix
    from alignment_algos_tpu.core.enumerators import (ConstrainedNearOptimal,
                                                      Optimal)
    from alignment_algos_tpu.core.enumerators import native as enat
    from alignment_algos_tpu.scoring.aasub import AASubstitutionEval
    from alignment_algos_tpu.scoring.submatrix import BlosumMatrix
    from alignment_algos_tpu.seq.sequence import AASequence
    from alignment_algos_tpu.seq.sflags import SuboptFlags
    from alignment_algos_tpu.utils.params import AliParams, NOaliParams

    if not enat.available():
        pytest.skip("native enumeration engine unavailable")

    rng = np.random.default_rng(5)
    alpha = "ARNDCQEGHILKMFPSTWYV"

    def mkseq(n):
        s = AASequence()
        s.append("".join(alpha[i] for i in rng.integers(0, 20, n)))
        return s

    import os
    bl = BlosumMatrix(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data", "BLOSUM62"))
    ap = AliParams()
    ap.align_type = 1
    ev = AASubstitutionEval(ap, bl)
    q, t = mkseq(256), mkseq(256)
    dpm = DPMatrix(q, t, ev, "fwd", ap.align_type)
    na = NOaliParams()
    na.number_suboptimal = 1000
    na.delta_ratio = 0.20
    flags = SuboptFlags(True, t.size())

    n_alis = 0

    def run():
        nonlocal n_alis
        as_ = AlignmentSet(dpm, Optimal(ap.align_type))
        ConstrainedNearOptimal(na, flags).enumerate(dpm, as_)
        n_alis = len(as_)

    run()  # warm (loads native lib)
    dt = _best_of(run)
    rate = n_alis / dt
    assert rate > 1500, f"native enum regressed: {rate:.0f} ali/s ({n_alis})"
