"""Functional checks for utils/profiling: a trace file actually appears
and the CUPS math holds."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from alignment_algos_tpu.utils import profiling


def test_trace_writes_artifacts(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.maybe_trace(logdir):
        with profiling.annotate("unit_region"):
            x = jax.jit(lambda v: jnp.sum(v * 2))(jnp.arange(128.0))
            x.block_until_ready()
    files = glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
    files = [f for f in files if os.path.isfile(f)]
    assert files, "XLA profiler produced no trace artifacts"
    assert any(f.endswith((".pb", ".json.gz", ".xplane.pb", ".trace.json.gz"))
               or "plugins" in f for f in files), files


def test_trace_noop_without_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("AAT_TRACE_DIR", raising=False)
    with profiling.maybe_trace() as d:
        assert d is None


def test_cups_math_and_stopwatch():
    assert profiling.cups(1000, 0.5) == 2000.0
    assert profiling.cups(1, 0.0) == float("inf")
    sw = profiling.Stopwatch()
    n = 10 ** 6
    rate = sw.cups(n)
    # the stopwatch rate must equal cells / its own elapsed reading to
    # within timer resolution
    assert 0 < sw.seconds() < 5.0
    assert rate > 0
