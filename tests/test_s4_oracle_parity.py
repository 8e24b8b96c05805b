"""End-to-end SSSS parity against the compiled reference enumerator.

tools/oracle_s4.cpp drives the reference's real SSSS stack (ssss.h,
frag_matrix.cpp, frag_set.cpp, skel_set.cpp, ali_strand_eval.cpp, ...)
on a feature-stub SMAPSequence loaded from our structure pipeline's dump,
replicating S4_align.cpp:109-138.  The full PIR stdout (fragment graph ->
skeleton enumeration -> loop sub-DP fills -> rendering) must match our
cli.s4_align / cli.s4_align_gn2 byte for byte.
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
ORACLE = "/tmp/refbuild/oracle_s4"

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="s4 oracle not built")

CASES = [
    ("hmap2", []),
    ("hmap2", ["--max_returned", "10"]),
    ("hmap2", ["--max_returned", "25", "--min_cov", "0.2",
               "--min_CO", "0.5"]),
    # global mode; thresholds loosened so the 222-res "real" fixture (remote
    # homolog, 30% divergence) still yields alignments
    ("hmap2", ["--ali_mode", "0", "--max_returned", "15",
               "--min_cov", "0.1", "--min_CO", "0.0"]),
    ("hmap2", ["--max_searched", "500", "--max_returned", "50"]),
    ("gn2", []),
    ("gn2", ["--max_returned", "20", "--min_cov", "0.3"]),
    ("gn2", ["--ali_mode", "0"]),
]


FIXTURES = {
    # 30-res fold (3 SSEs) and a 51-res fold (2 helices + 3 strands:
    # bigger fragment graph, live strand rules; tools/make_smap_fixture.py)
    "small": ("templ_smap.prof", "query30.prof"),
    "big": ("templ_big.prof", "query_big.prof"),
    # 222-res deposited-style pathological PDB + homologous 180-res query
    # (tools/make_smap_fixture.make_fixture_real)
    "real": ("templ_real.prof", "query_real.prof"),
}


@pytest.fixture(scope="module")
def dumps():
    out = {}
    for tag, (tfn, qfn) in FIXTURES.items():
        templ = SMAPSequence.from_file(os.path.join(DATA, tfn), gn2=True)
        out[tag] = make_dump(templ, os.path.join(DATA, qfn), ssss=True)
    return out


def run_reference(mode: str, extra: list[str], dump: str) -> str:
    # content-keyed golden cache: the slowest case needs ~80% of a 300 s
    # budget on an idle machine and times out under concurrent suite load
    # (observed); replaying the recorded output makes pass/fail
    # load-independent while any source/fixture change still re-runs
    from oracle_cache import cached_run
    return cached_run(
        "s4", [ORACLE, mode] + extra, dump,
        driver_sources=[os.path.join(ROOT, "tools", "oracle_s4.cpp")],
        env={**os.environ, "HOME": "/tmp/refbuild"})


def run_ours(mode: str, extra: list[str], fixture: str = "small") -> str:
    module = ("alignment_algos_tpu.cli.s4_align_gn2" if mode == "gn2"
              else "alignment_algos_tpu.cli.s4_align")
    tfn, qfn = FIXTURES[fixture]
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run(
        [sys.executable, "-m", module,
         os.path.join(DATA, tfn),
         os.path.join(DATA, qfn)] + extra,
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
@pytest.mark.parametrize("mode,extra", CASES)
def test_s4_pir_output_parity(mode, extra, fixture, dumps):
    ref = run_reference(mode, extra, dumps[fixture])
    ours = run_ours(mode, extra, fixture)
    assert ref.strip(), "reference produced no alignments (bad fixture?)"
    assert ours == ref
