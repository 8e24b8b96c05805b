"""End-to-end `gn2` / `nalign2` CLI parity against the compiled reference.

tools/oracle_gn2cli.cpp replicates gn2.cpp:25-239 — including the flagship
-crcw iterative rounds (enumerate -> updateCore -> reevaluate -> repeat ->
final enumeration with final_overlap) — on the feature-stub SMAPSequence
whose updateCore runs the reference formula (gn2lib_seq.cpp:289-326) over
our dumped squared-CB distances.  tools/oracle_nalign2.cpp replicates
nalign2.cpp:19-176 (single enumeration, no rounds).  Full stdout must
match our cli.gn2 / cli.nalign2 byte for byte.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from alignment_algos_tpu.structure.smap import SMAPSequence

from smap_dump import make_dump

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
ORACLE_GN2 = "/tmp/refbuild/oracle_gn2cli"
ORACLE_NALIGN2 = "/tmp/refbuild/oracle_nalign2"

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE_GN2),
                                reason="gn2 cli oracle not built")

GN2_CASES = [
    ["-opt"],
    ["-ucw"],
    ["-kscw"],
    [],                                   # default cw
    ["-crcw"],                            # iterative rounds + final pass
    ["-crcw", "--ROUNDS", "3"],
    ["-crcw", "-showrounds"],
    ["-crcw", "--NUM_SUBOPT", "1"],       # opt-after-rounds branch
    ["-crcw", "--NUM_SUBOPT", "0"],       # fresh-opt-after-rounds branch
    ["-crcw", "--OUTPUT_FORMAT", "1"],    # PIR
    ["-opt", "--OUTPUT_FORMAT", "0",      # HMAP 5-row blocks + match marks
     "--SUB_MATRIX", os.path.join(DATA, "BLOSUM62")],
]

NALIGN2_CASES = [["-opt"], ["-ucw"], ["-kscw"], ["-crcw"], []]

# HMAPRC_use_this_param_file production values (HMAPRC:1-55) as CLI
# overrides — the reference's real-protein production invocation
# (gn2.cpp:114-195)
PRODUCTION = ["--NUM_SUBOPT", "1000", "--DELTA_RATIO", "0.20",
              "--MAX_OVERLAP", "0.05", "--FINAL_OVERLAP", "0.30",
              "--ALIGN_MODE", "4"]

# realistic-scale battery: the 222-residue pathological fixture + 180-res
# homologous query.  Wall time of the whole real-scale
# battery is recorded in docs/SCALING.md.
GN2_REAL_CASES = [
    ["-opt"],
    ["-crcw"] + PRODUCTION,
    ["-crcw", "--ROUNDS", "3"] + PRODUCTION,
    ["-kscw"],
]

NALIGN2_REAL_CASES = [["-opt"], ["-crcw"] + PRODUCTION]

FIXTURES = {
    "small": ("templ_smap.prof", "query30.prof"),
    "real": ("templ_real.prof", "query_real.prof"),
}


@pytest.fixture(scope="module")
def dumps():
    out = {}
    for tag, (tfn, qfn) in FIXTURES.items():
        templ = SMAPSequence.from_file(os.path.join(DATA, tfn), gn2=True)
        out[tag] = make_dump(templ, os.path.join(DATA, qfn), ssss=True)
    return out


def run_reference(oracle: str, extra: list[str], dump: str) -> str:
    r = subprocess.run([oracle] + extra, input=dump, capture_output=True,
                       text=True, env={**os.environ, "HOME": "/tmp/refbuild"},
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def run_ours(module: str, extra: list[str], fixture: str = "small") -> str:
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    tfn, qfn = FIXTURES[fixture]
    r = subprocess.run(
        [sys.executable, "-m", f"alignment_algos_tpu.cli.{module}",
         os.path.join(DATA, qfn), os.path.join(DATA, tfn)] + extra,
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


@pytest.mark.parametrize("extra", GN2_CASES)
def test_gn2_cli_parity(extra, dumps):
    args = extra + ["--OUTPUT_FORMAT", "2"] if "--OUTPUT_FORMAT" not in extra \
        else extra
    ref = run_reference(ORACLE_GN2, args, dumps["small"])
    ours = run_ours("gn2", args)
    assert ref.strip(), "reference produced no output"
    assert ours == ref


@pytest.mark.parametrize("extra", GN2_REAL_CASES)
def test_gn2_cli_parity_real_scale(extra, dumps):
    args = extra + ["--OUTPUT_FORMAT", "2"]
    ref = run_reference(ORACLE_GN2, args, dumps["real"])
    ours = run_ours("gn2", args, fixture="real")
    assert ref.strip(), "reference produced no output"
    assert ours == ref


@pytest.mark.skipif(not os.path.exists(ORACLE_NALIGN2),
                    reason="nalign2 oracle not built")
@pytest.mark.parametrize("extra", NALIGN2_CASES)
def test_nalign2_cli_parity(extra, dumps):
    args = extra + ["--OUTPUT_FORMAT", "2"]
    ref = run_reference(ORACLE_NALIGN2, args, dumps["small"])
    ours = run_ours("nalign2", args)
    assert ref.strip(), "reference produced no output"
    assert ours == ref


@pytest.mark.skipif(not os.path.exists(ORACLE_NALIGN2),
                    reason="nalign2 oracle not built")
@pytest.mark.parametrize("extra", NALIGN2_REAL_CASES)
def test_nalign2_cli_parity_real_scale(extra, dumps):
    args = extra + ["--OUTPUT_FORMAT", "2"]
    ref = run_reference(ORACLE_NALIGN2, args, dumps["real"])
    ours = run_ours("nalign2", args, fixture="real")
    assert ref.strip(), "reference produced no output"
    assert ours == ref


# ---------------------------------------------------------------------------
# gnoali CLI (tools/oracle_gnoali.cpp — gnoali.cpp:19-121; exercises the
# LogisticNormal e-value annotations end to end)

ORACLE_GNOALI = "/tmp/refbuild/oracle_gnoali"

GNOALI_CASES = [["-opt"], [], ["--OUTPUT_FORMAT", "1"]]


@pytest.fixture(scope="module")
def gnoali_dump():
    templ = SMAPSequence.from_file(os.path.join(DATA, "templ_smap.prof"),
                                   gn2=False)
    return make_dump(templ, os.path.join(DATA, "query30.prof"), ssss=True)


@pytest.mark.skipif(not os.path.exists(ORACLE_GNOALI),
                    reason="gnoali oracle not built")
@pytest.mark.parametrize("extra", GNOALI_CASES)
def test_gnoali_cli_parity(extra, gnoali_dump):
    args = extra + (["--OUTPUT_FORMAT", "2"]
                    if "--OUTPUT_FORMAT" not in extra else [])
    ref = run_reference(ORACLE_GNOALI, args, gnoali_dump)
    ours = run_ours("gnoali", args)
    assert ref.strip(), "reference produced no output"
    assert "ev=" in ours or "--OUTPUT_FORMAT" in extra
    assert ours == ref
