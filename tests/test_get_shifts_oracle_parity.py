"""Byte-level parity of the `get_shifts` evaluation harness against the
compiled reference binary (get_shifts.cpp:92-245: per-rank %id / aligned
length / residue shift / area shift / n_agree / Q_mod / Q_dev / Q_comb
running + cumulative tables).

The reference binary doesn't compile as shipped (missing aasubalib.h
include and a template-name passed as a type argument, get_shifts.cpp:26)
— patched in tools/build_reference.py.  Like all FastaRead consumers it
needs a trailing blank line on the native-alignment file (stale-getline
EOF bug, see make_golden.py): without one it mis-reads the second sequence
and either aborts or spins forever.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
ORACLE = "/tmp/refbuild/get_shifts"

pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="reference get_shifts not built")

TEMPL = "HEAGAWGHEEHEAGAWGHEE"
QUERY = "PAWHEAEPAWHEAE"


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """PIR batch + native alignment generated through our aaa CLI."""
    tmp = tmp_path_factory.mktemp("gs")
    fa = tmp / "seqs.fa"
    fa.write_text(f"> templ\n{TEMPL}\n> query\n{QUERY}\n\n")
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run(
        [sys.executable, "-m", "alignment_algos_tpu.cli.aaa", str(fa),
         "--SUB_MATRIX", os.path.join(DATA, "BLOSUM62"),
         "--ALIGN_MODE", "1", "--OUTPUT_FORMAT", "1",
         "--DELTA_RATIO", "0.3", "--NUM_SUBOPT", "6"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    txt = r.stdout
    pir = tmp / "batch.pir"
    pir.write_text(txt[txt.index("#start"):txt.rindex("#end") + 4] + "\n")

    from alignment_algos_tpu.io.pir import read_pir
    with open(pir) as f:
        first = read_pir(f)
    t_str = first.get_templ_string(f"^{TEMPL}$")[1:-1]
    q_str = first.get_query_string(f"^{QUERY}$")[1:-1]
    nat = tmp / "native.fa"
    # trailing blank line: FastaRead EOF-bug workaround
    nat.write_text(f"> t\n{t_str}\n> q\n{q_str}\n\n")
    return str(pir), str(nat)


def test_get_shifts_tables_byte_equal(fixtures):
    pir, nat = fixtures
    ref = subprocess.run([ORACLE, pir, nat],
                         capture_output=True, text=True, timeout=60)
    assert ref.returncode == 0, ref.stderr[-1000:]
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    ours = subprocess.run(
        [sys.executable, "-m", "alignment_algos_tpu.cli.get_shifts",
         pir, nat],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert ours.returncode == 0, ours.stderr[-2000:]
    assert "Running statistics" in ref.stdout and "[C]" in ref.stdout
    assert ours.stdout == ref.stdout


@pytest.fixture(scope="module")
def fixtures_real(tmp_path_factory):
    """Realistic-scale inputs: a PIR batch from our gn2
    CLI at HMAPRC production parameters on the 222-res fixture, measured
    against the optimal Hmap2 alignment as native."""
    tmp = tmp_path_factory.mktemp("gs_real")
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    qfn = os.path.join(DATA, "query_real.prof")
    tfn = os.path.join(DATA, "templ_real.prof")
    r = subprocess.run(
        [sys.executable, "-m", "alignment_algos_tpu.cli.gn2", qfn, tfn,
         "-crcw", "--NUM_SUBOPT", "1000", "--DELTA_RATIO", "0.20",
         "--MAX_OVERLAP", "0.05", "--FINAL_OVERLAP", "0.30",
         "--ALIGN_MODE", "4", "--OUTPUT_FORMAT", "1"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    txt = r.stdout
    pir = tmp / "batch.pir"
    pir.write_text(txt[txt.index("#start"):txt.rindex("#end") + 4] + "\n")

    from alignment_algos_tpu.io.pir import read_pir
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    q_seq = HMAPSequence.from_file(qfn).get_string()[1:-1]
    t_seq = HMAPSequence.from_file(tfn).get_string()[1:-1]
    with open(pir) as f:
        first = read_pir(f)
    t_str = first.get_templ_string(f"^{t_seq}$")[1:-1]
    q_str = first.get_query_string(f"^{q_seq}$")[1:-1]
    nat = tmp / "native.fa"
    nat.write_text(f"> t\n{t_str}\n> q\n{q_str}\n\n")
    return str(pir), str(nat)


def test_get_shifts_tables_byte_equal_real_scale(fixtures_real):
    pir, nat = fixtures_real
    ref = subprocess.run([ORACLE, pir, nat],
                         capture_output=True, text=True, timeout=120)
    assert ref.returncode == 0, ref.stderr[-1000:]
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    ours = subprocess.run(
        [sys.executable, "-m", "alignment_algos_tpu.cli.get_shifts",
         pir, nat],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert ours.returncode == 0, ours.stderr[-2000:]
    assert "Running statistics" in ref.stdout and "[C]" in ref.stdout
    assert ours.stdout == ref.stdout
