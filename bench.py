#!/usr/bin/env python3
"""Benchmark: library-screen and exact-alignment throughput on one GPU.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "device":
{...}, "detail": {...}}.  Every time is the median of ``REPS`` warm calls
that end in ``block_until_ready`` or a host pull, reported with its
spread (max - min); compilation happens in an untimed first call.  The
device block names the card and its power limit as ``nvidia-smi``
reports them.  The script fails when JAX finds no GPU.

Headline: one 512-residue query against a 5,120 x 512 template library
through ``screen_library`` (BLOSUM62, gaps 11/1), in cell updates per
second.  Details:

  config1  one 512 x 512 exact general-gap DP + optimal traceback at the
           reference's fractional gaps (device engine), the same at 11/1
           gaps (host affine path), and 16 distinct pairs through the
           batched scores engine (ops/dp_scores)
  config2  100 x 256 library screen + traceback + ali_dist + UPGMA
  config3  near-optimal enumeration at HMAPRC parameters, 512 x 512
  config4  HMAP profile screen, 16 templates x 256, device-built
  config5  16 queries against the 5,120 x 512 library (``screen_grid``)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BLOSUM = os.path.join(ROOT, "tests", "data", "BLOSUM62")
N_LIB, LEN, GI, GE = 5120, 512, 11.0, 1.0
PAIR = 512          # exact-alignment pair length (configs 1 and 3)
REPS = 5


def timed(fn, reps: int = REPS) -> dict:
    """Median and spread of ``reps`` warm calls (one untimed first call
    compiles)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return {"median_s": float(np.median(ts)),
            "spread_s": float(max(ts) - min(ts)), "reps": reps}


def _mkseq(rng, n):
    from alignment_algos_tpu.seq.sequence import AASequence
    s = AASequence()
    s.append("".join("ARNDCQEGHILKMFPSTWYV"[i]
                     for i in rng.integers(0, 20, n)))
    return s


def _align(ev, ap, rng, n=None):
    from alignment_algos_tpu.core.alignment import AlignmentSet
    from alignment_algos_tpu.core.dp import DPMatrix
    from alignment_algos_tpu.core.enumerators import Optimal
    q, t = _mkseq(rng, n or PAIR), _mkseq(rng, n or PAIR)

    def run():
        dpm = DPMatrix(q, t, ev, "fwd", ap.align_type)
        assert len(AlignmentSet(dpm, Optimal(ap.align_type))) == 1
    return run


def config1_exact_pairwise(bl) -> dict:
    from alignment_algos_tpu.ops import dp_scores
    from alignment_algos_tpu.scoring.aasub import AASubstitutionEval
    from alignment_algos_tpu.utils.params import AliParams

    rng = np.random.default_rng(3)
    ap = AliParams()
    ap.align_type = 1
    ev = AASubstitutionEval(ap, bl)
    out = {"fractional_gaps": timed(_align(ev, ap, rng))}
    ap11 = AliParams()
    ap11.align_type = 1
    ap11.gap_init_penalty, ap11.gap_extn_penalty = GI, GE
    out["gaps_11_1"] = timed(_align(AASubstitutionEval(ap11, bl), ap11,
                                    rng))
    costs = [ev.build_costs(_mkseq(rng, PAIR), _mkseq(rng, PAIR))
             for _ in range(16)]
    out["batched_16_pairs"] = timed(
        lambda: dp_scores.forward_scores_batch(costs))
    return out


def config2_screen_cluster(bl) -> dict:
    import contextlib
    import io

    from alignment_algos_tpu.cli.screen import (_cluster_hits,
                                                encode_library, padded_table)
    from alignment_algos_tpu.parallel import screen as ps

    rng = np.random.default_rng(4)
    nlib, length = 100, LEN // 2
    alpha = "ARNDCQEGHILKMFPSTWYV"
    qseq = "".join(alpha[i] for i in rng.integers(0, 20, length))
    seqs = ["".join(alpha[i] for i in rng.integers(0, 20, length))
            for _ in range(nlib)]
    table, pad_code = padded_table(bl)
    index = {c: i for i, c in enumerate(bl.alphabet)}
    q_codes = np.asarray([index[c] for c in qseq], dtype=np.int32)
    t_codes = encode_library(seqs, index, pad_code)

    def run():
        scores, idx = ps.screen_library(q_codes, t_codes, table, GI, GE,
                                        k=nlib)
        with contextlib.redirect_stdout(io.StringIO()):
            _cluster_hits(q_codes, t_codes, table, GI, GE, scores, idx,
                          [f"t{i}" for i in range(nlib)], 8.0, pad_code)
    return {"library": nlib, "length": length, **timed(run)}


def config3_enumeration(bl) -> dict:
    from alignment_algos_tpu.core.alignment import AlignmentSet
    from alignment_algos_tpu.core.dp import DPMatrix
    from alignment_algos_tpu.core.enumerators import (ConstrainedNearOptimal,
                                                      Optimal)
    from alignment_algos_tpu.scoring.aasub import AASubstitutionEval
    from alignment_algos_tpu.seq.sflags import SuboptFlags
    from alignment_algos_tpu.utils.params import AliParams, NOaliParams

    rng = np.random.default_rng(5)
    ap = AliParams()
    ap.align_type = 1
    q, t = _mkseq(rng, PAIR), _mkseq(rng, PAIR)
    dpm = DPMatrix(q, t, AASubstitutionEval(ap, bl), "fwd", ap.align_type)
    na = NOaliParams()
    na.number_suboptimal = 1000
    na.delta_ratio = 0.20
    n = []

    def run():
        as_ = AlignmentSet(dpm, Optimal(ap.align_type))
        ConstrainedNearOptimal(na, SuboptFlags(True, t.size())).enumerate(
            dpm, as_)
        as_.assign_identity()
        n.append(len(as_))
    out = timed(run)
    return {"alignments": n[-1],
            "alignments_per_s": n[-1] / out["median_s"], **out}


def config4_hmap_profile() -> dict:
    import io
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_profiles import make_profile

    from alignment_algos_tpu.ops import hmap_device
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.utils.params import HMAPaliParams

    rng = np.random.default_rng(6)
    ntempl, length = 16, LEN // 2
    seqs = [HMAPSequence.from_stream(io.StringIO(
        make_profile(rng, f"s{i}", length))) for i in range(ntempl + 1)]
    query, templates = seqs[0], seqs[1:]
    params = HMAPaliParams()
    ev = HMAPaliEval(params)
    lib = hmap_device.DeviceLibrary(templates, ev)
    out = timed(lambda: hmap_device.screen_hmap_device(
        query, templates, params, k=5, library=lib, ev=ev))
    q2 = t2 = length + 2
    cand = ntempl * q2 * t2 * (q2 + t2)
    return {"templates": ntempl, "length": length,
            "candidate_evals_per_s": cand / out["median_s"], **out}


def config5_many_queries(bl) -> dict:
    from alignment_algos_tpu.parallel import screen as ps

    rng = np.random.default_rng(9)
    nq = 16
    lib = rng.integers(0, 20, (N_LIB, LEN)).astype(np.int32)
    qs = rng.integers(0, 20, (nq, LEN)).astype(np.int32)
    table = np.asarray(bl.matrix[:20, :20], np.float32)
    out = timed(lambda: ps.screen_grid(qs, lib, table, GI, GE, k=10),
                reps=3)
    return {"queries": nq, "library": N_LIB, "length": LEN,
            "cells_per_s": nq * N_LIB * LEN * LEN / out["median_s"], **out}


def card_name() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    sys.path.insert(0, ROOT)
    from alignment_algos_tpu.utils.jaxenv import setup_jax
    setup_jax()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform})", file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card_name()}

    from alignment_algos_tpu.parallel import screen as ps
    from alignment_algos_tpu.scoring.submatrix import BlosumMatrix
    bl = BlosumMatrix(BLOSUM)
    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, LEN).astype(np.int32)
    lib = rng.integers(0, 20, (N_LIB, LEN)).astype(np.int32)
    table = np.asarray(bl.matrix[:20, :20], np.float32)
    mesh = ps.default_mesh(1)
    head = timed(lambda: ps.screen_library(q, lib, table, GI, GE, k=10,
                                           mesh=mesh))
    cells = N_LIB * LEN * LEN
    configs = {}
    for name, fn in (("config1_exact_pairwise", lambda: config1_exact_pairwise(bl)),
                     ("config2_screen_cluster", lambda: config2_screen_cluster(bl)),
                     ("config3_enumeration", lambda: config3_enumeration(bl)),
                     ("config4_hmap_profile", config4_hmap_profile),
                     ("config5_many_queries", lambda: config5_many_queries(bl))):
        configs[name] = fn()
    print(json.dumps({
        "metric": "library_screen_cell_updates_per_sec",
        "value": cells / head["median_s"] / 1e9, "unit": "GCUPS",
        "device": device,
        "detail": {"library": N_LIB, "length": LEN,
                   "engine": ps.pick_engine(mesh, GI, GE), **head,
                   "configs": configs}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
