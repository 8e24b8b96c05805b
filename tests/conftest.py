"""Test configuration: the suite runs on the host CPU with a virtual
8-device mesh.  Tests that need the GPU carry the ``gpu`` marker and
decide inside the ``gpu_devices`` fixture whether a card is present."""

import os
import subprocess
import sys

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

from alignment_algos_tpu.utils.jaxenv import REPO_ROOT as ROOT  # noqa: E402
from alignment_algos_tpu.utils.jaxenv import setup_jax  # noqa: E402

setup_jax()


def gpu_env() -> dict:
    """Environment for a child process that may open the GPU: the
    suite's CPU pinning and virtual-device flags removed."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="session")
def gpu_devices() -> int:
    """Number of GPUs a fresh JAX process sees; skips the test when there
    is none.  Decided here, never at import, so every test worker
    collects the same tests."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices(); "
         "print(len(d) if d[0].platform == 'gpu' else 0)"],
        capture_output=True, text=True, env=gpu_env(), timeout=600)
    lines = r.stdout.split()
    n = int(lines[-1]) if r.returncode == 0 and lines else 0
    if n == 0:
        pytest.skip("no GPU: JAX finds no CUDA device")
    return n
