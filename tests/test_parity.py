"""Golden parity vs the reference binaries.

Fixtures in tests/golden/ were produced by the compiled reference
(tools/build_reference.py + tools/make_golden.py).  Both aaa and nalign
outputs are compared byte-for-byte: utils/hmath.py replicates the
reference's strictly sequential float32 accumulation order (valarray sums)
in the similarity dot products and z-normalization, so even the floating
numeric annotations match exactly.  (fuzzy_equal remains as a diagnostic
helper for triaging future fixture regressions.)
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")
INP = os.path.join(GOLD, "inputs")
BLOSUM = os.path.join(ROOT, "tests", "data", "BLOSUM62")

pytestmark = pytest.mark.skipif(not os.path.isdir(GOLD),
                                reason="golden fixtures not generated")


def run_mine(module: str, args: list[str]) -> str:
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    env.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
    env.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
    env["HOME"] = "/tmp/nonexistent-home"  # no ~/.hmaprc
    r = subprocess.run([sys.executable, "-m", f"alignment_algos_tpu.cli.{module}"]
                      + args, capture_output=True, text=True, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [l for l in r.stdout.splitlines()
             if not l.startswith("time for alignment")
             and not l.startswith("total cpu time")]
    return "\n".join(lines) + "\n"


def gold(name: str) -> str:
    with open(os.path.join(GOLD, name + ".out")) as f:
        return f.read()


AAA_CASES = []
for pi in range(4):
    for mode in range(5):
        for tag, extra in (("cw", []), ("opt", ["-opt"])):
            AAA_CASES.append((pi, mode, tag, extra))


@pytest.mark.parametrize("pi,mode,tag,extra", AAA_CASES)
def test_aaa_parity(pi, mode, tag, extra):
    fa = os.path.join(INP, f"aaa_pair{pi}.fa")
    out = run_mine("aaa", [fa, "--SUB_MATRIX", BLOSUM,
                           "--ALIGN_MODE", str(mode),
                           "--DELTA_RATIO", "0.25",
                           "--NUM_SUBOPT", "20"] + extra)
    assert out == gold(f"aaa_p{pi}_m{mode}_{tag}")


def test_aaa_pir_parity():
    fa = os.path.join(INP, "aaa_pair1.fa")
    out = run_mine("aaa", [fa, "--SUB_MATRIX", BLOSUM, "--ALIGN_MODE", "1",
                           "--OUTPUT_FORMAT", "1", "--NUM_SUBOPT", "5",
                           "--DELTA_RATIO", "0.15"])
    assert out == gold("aaa_pir")


# ---------------------------------------------------------------------------
_NUM = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")


def fuzzy_equal(mine: str, ref: str, rtol: float = 1.5e-3) -> None:
    """Line-by-line equality with numeric tolerance."""
    ml = mine.splitlines()
    rl = ref.splitlines()
    assert len(ml) == len(rl), (
        f"line count differs: {len(ml)} vs {len(rl)}\n"
        f"mine tail: {ml[-5:]}\nref tail: {rl[-5:]}")
    for i, (m, r) in enumerate(zip(ml, rl)):
        if m == r:
            continue
        mn = _NUM.findall(m)
        rn = _NUM.findall(r)
        assert _NUM.sub("#", m) == _NUM.sub("#", r), \
            f"line {i} structure differs:\n mine: {m}\n ref:  {r}"
        assert len(mn) == len(rn)
        for a, b in zip(mn, rn):
            fa, fb = float(a), float(b)
            denom = max(abs(fa), abs(fb), 1e-3)
            assert abs(fa - fb) / denom < rtol, \
                f"line {i} numeric differs: {a} vs {b}\n mine: {m}\n ref:  {r}"


NALIGN_CASES = {
    "nalign_opt": ["qA.prof", "tA.prof", "-opt"],
    "nalign_cw_default": ["qA.prof", "tA.prof",
                          "--DELTA_RATIO", "0.1", "--NUM_SUBOPT", "30"],
    "nalign_cw_flags": ["qA.prof", "tA.prof", "tA.flag",
                        "--DELTA_RATIO", "0.1", "--NUM_SUBOPT", "30"],
    "nalign_ucw": ["qA.prof", "tA.prof", "-ucw",
                   "--DELTA_RATIO", "0.05", "--NUM_SUBOPT", "30"],
    "nalign_B_opt": ["qB.prof", "tB.prof", "-opt"],
    "nalign_B_cw": ["qB.prof", "tB.prof",
                    "--DELTA_RATIO", "0.08", "--NUM_SUBOPT", "25"],
    "nalign_mode0": ["qA.prof", "tA.prof", "-opt", "--ALIGN_MODE", "0"],
    "nalign_mode1": ["qA.prof", "tA.prof", "-opt", "--ALIGN_MODE", "1"],
    "nalign_mode2": ["qA.prof", "tA.prof", "-opt", "--ALIGN_MODE", "2"],
    "nalign_pir": ["qA.prof", "tA.prof", "-opt", "--OUTPUT_FORMAT", "1"],
    "nalign_hmap": ["qA.prof", "tA.prof", "-opt", "--OUTPUT_FORMAT", "0",
                    "--SUB_MATRIX", BLOSUM],
}


@pytest.mark.parametrize("name", sorted(NALIGN_CASES))
def test_nalign_parity(name):
    args = [os.path.join(INP, a) if a.endswith((".prof", ".flag")) else a
            for a in NALIGN_CASES[name]]
    out = run_mine("nalign", args)
    # byte-equal: the z-normalization and similarity sums replicate the
    # reference's sequential float32 accumulation order (utils/hmath.py),
    # so even the numeric annotations match exactly
    assert out == gold(name)
