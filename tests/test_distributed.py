"""Real multi-process jax.distributed execution (CPU backend, local TCP):
the sharded library screen over a global mesh spanning 2 and 4 processes
must return bit-identical results to the single-process path.

This is the honest pod stand-in available without multi-host hardware
(BASELINE.md scaling north star)."""

import numpy as np
import pytest

from alignment_algos_tpu.parallel.distributed import launch_local_screen
from alignment_algos_tpu.parallel.screen import (default_mesh,
                                                 screen_library)

Q, T, N, K = 24, 20, 13, 5


def _inputs():
    rng = np.random.default_rng(11)
    q = rng.integers(0, 20, Q).astype(np.int32)
    lib = rng.integers(0, 20, (N, T)).astype(np.int32)
    table = rng.integers(-4, 12, (20, 20)).astype(np.float32)
    return q, lib, table


@pytest.mark.parametrize("num_processes,devices_per_process",
                         [(2, 2), (4, 1)])
def test_multiprocess_screen_bit_identical(num_processes,
                                           devices_per_process):
    q, lib, table = _inputs()
    # single-process reference on a virtual mesh of the same total size
    mesh = default_mesh(num_processes * devices_per_process)
    ref_scores, ref_idx = screen_library(q, lib, table, 11.0, 1.0, k=K,
                                         mesh=mesh, engine="xla")

    results = launch_local_screen(q, lib, table, 11.0, 1.0, K,
                                  num_processes=num_processes,
                                  devices_per_process=devices_per_process)
    assert len(results) == num_processes
    for scores, idx in results:
        np.testing.assert_array_equal(scores, ref_scores)
        np.testing.assert_array_equal(idx, ref_idx)
