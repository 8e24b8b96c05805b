"""GPU-only checks: the phases of chip_smoke.py, each in a child process
that opens the card, at the deployment sizes.  They skip where JAX finds
no GPU (the ``gpu_devices`` fixture); on the card run

    python -m pytest -m gpu tests/test_gpu.py -v

or ``python chip_smoke.py``, which runs the same checks in one process.
"""

from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import ROOT, gpu_env

pytestmark = pytest.mark.gpu

_PROG = """
import sys, tempfile
import chip_smoke as c
c.CARD = c.card_name()
with tempfile.TemporaryDirectory() as tmp:
    {call}
print("PHASE_OK")
"""


def _run_phase(call: str, timeout: float = 1200.0) -> None:
    r = subprocess.run([sys.executable, "-c", _PROG.format(call=call)],
                       capture_output=True, text=True, env=gpu_env(),
                       cwd=ROOT, timeout=timeout)
    assert r.returncode == 0 and "PHASE_OK" in r.stdout, (
        r.stdout[-3000:] + r.stderr[-3000:])


def test_screen_phase_on_gpu(gpu_devices):
    """Triton strip kernel bit-equal to the XLA engines and the numpy
    oracle at 5,120 x 512 x 512; traceback decode device == host."""
    _run_phase("c.phase_screen(c.FULL, tmp, {})")


def test_profile_phase_on_gpu(gpu_devices):
    """Device HMAP similarity and scores bit-equal to the host paths;
    dp_scores == dp_ref at 258/514/700."""
    _run_phase("c.phase_profiles(c.FULL, tmp, {})")


def test_pairwise_phase_on_gpu(gpu_devices):
    """aaa with the device engine byte-equal to the host oracle and to
    the golden fixtures."""
    _run_phase("c.phase_pairwise(c.FULL, tmp, {})")


def test_four_card_phase_on_gpu(gpu_devices):
    if gpu_devices < 4:
        pytest.skip(f"needs 4 GPUs, found {gpu_devices}")
    _run_phase("c.phase_cards(c.FULL, tmp, 4)")
