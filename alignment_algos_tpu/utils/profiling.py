"""Profiling/observability hooks (SURVEY.md section 5: the reference has
wall-clock ``clock()`` pairs only — nalign.cpp:23,74,104; the
equivalent here is the XLA profiler plus cell-updates-per-second counters).

Usage:
    with profiling.maybe_trace():          # no-op unless AAT_TRACE_DIR set
        scores = engine(...)

    with profiling.annotate("sw_affine"):  # named region in the trace
        ...

    rate = profiling.cups(cells, seconds)  # cell updates / second

Set ``AAT_TRACE_DIR=/tmp/trace`` to capture an XLA profiler trace viewable
in TensorBoard / Perfetto; every CLI and bench.py honors it.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def maybe_trace(logdir: str | None = None):
    """XLA profiler trace if a directory is given or AAT_TRACE_DIR is set."""
    logdir = logdir or os.environ.get("AAT_TRACE_DIR", "")
    if not logdir:
        yield None
        return
    import jax
    with jax.profiler.trace(logdir):
        yield logdir


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    import jax
    return jax.profiler.TraceAnnotation(name)


def cups(cells: int, seconds: float) -> float:
    """Cell updates per second — the DP throughput metric (BASELINE.md)."""
    return cells / seconds if seconds > 0 else float("inf")


class Stopwatch:
    """Reference-style wall-clock pair ("time for alignment was ...",
    nalign.cpp:119-124) with a CUPS readout for DP engines."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def seconds(self) -> float:
        return time.perf_counter() - self.t0

    def cups(self, cells: int) -> float:
        return cups(cells, self.seconds())
