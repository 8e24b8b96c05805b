#!/usr/bin/env python3
"""Drive the system's main path once on the GPU and check every result
against the plain host references.

    python chip_smoke.py             # one card: the phases below
    python chip_smoke.py --cards 4   # four cards: only the sharded path

One card, through the user entry points, at deployment sizes:

  screen    ``aat_screen``: one 512-residue query against a seeded library
            of 5,120 x 512-residue templates (BLOSUM62, gaps 11/1, top 10),
            with the top-hit traceback and UPGMA clustering.  Library
            scores from the Triton strip kernel are compared bit for bit
            with the anti-diagonal XLA engine over all templates, and with
            the numpy Gotoh oracle on the top hits plus 16 seeded
            templates; the kernel, the plain lax row scan and both screen
            engines are timed; 100 hits x 512 go through the traceback,
            decoded on device and on host from the same codes.
  profiles  ``aat_screen --profiles 1``: a 256-residue HMAP query profile
            (258 with sentinels) against 256 seeded template profiles of
            98-698 residues, similarity built and scored on the card.
            Device similarity is compared with the host ``build_costs``
            at every template length, all scores with host cost builds scored
            on the card, the top hits plus 16 seeded templates with the
            native host DP, and the scores engine with ``dp_ref`` at
            q2 = t2 = 258, 514 and 700.
  pairwise  ``aaa`` on one 512 x 512 pair at the default fractional gaps,
            general DP engine on the card, byte-equal to the host oracle's
            run; then golden ``aaa`` fixtures with the device engine.

Four cards (``--cards 4``): ``screen_library`` on a 4-card mesh against
one card, ``screen_grid`` on a (2, 2) mesh with 16 queries against one
card, ``screen_profiles`` sharded against unsharded; every card must
hold its own shard.

The script exits non-zero at the first failed check, and at once when
JAX finds no GPU.  Its last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BLOSUM = os.path.join(ROOT, "tests", "data", "BLOSUM62")
AA = "ARNDCQEGHILKMFPSTWYV"

FULL = dict(query_len=512, n_templates=5120, templ_len=512, top_k=10,
            n_seeded=16, tb_hits=100, prof_query=256,
            prof_lengths=(98, 256, 512, 698), n_prof=256,
            dp_sizes=(258, 514, 700), pair_len=512, reps=5,
            grid_queries=16)
# the same phases at toy sizes, for the CPU rehearsal in the tests
SMALL = dict(query_len=40, n_templates=70, templ_len=33, top_k=10,
             n_seeded=4, tb_hits=8, prof_query=20, prof_lengths=(12, 20),
             n_prof=6, dp_sizes=(12, 17), pair_len=30, reps=1,
             grid_queries=4)
GOLDEN_AAA = [(0, 1, []), (1, 2, ["-opt"]), (2, 3, []), (3, 4, ["-opt"]),
              (1, 0, [])]

CARD = "unknown card"


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def same_bits(a, b) -> bool:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a.shape == b.shape and bool(
        (a.view(np.uint32) == b.view(np.uint32)).all())


def report(name: str, seconds: float) -> None:
    print(f"time {name}: {seconds:.6f} s ({CARD})", flush=True)


def timed(fn, reps: int):
    """Median and spread of ``reps`` warm calls; ``fn`` must return
    arrays that are ready when it returns (np.asarray or
    block_until_ready)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(max(ts) - min(ts))


def run_cli(module, argv) -> str:
    import importlib
    mod = importlib.import_module(f"alignment_algos_tpu.cli.{module}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    check(rc == 0, f"{module} exited 0")
    return buf.getvalue()


def parse_ranks(out: str):
    rows = [line.split("\t") for line in out.splitlines()
            if line and line[0].isdigit() and "\t" in line]
    return (np.array([float(r[1]) for r in rows], np.float32),
            np.array([int(r[2]) for r in rows]))


def _write_fasta(path, names, seqs):
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n{s}\n")


# ---------------------------------------------------------------------------
# phase 1: substitution library screen


def phase_screen(sz, tmp, timings: dict) -> None:
    import jax
    import jax.numpy as jnp
    from alignment_algos_tpu.cli.screen import encode_library, padded_table
    from alignment_algos_tpu.ops import swaffine, swscan
    from alignment_algos_tpu.parallel import screen as ps
    from alignment_algos_tpu.scoring.submatrix import BlosumMatrix

    print("phase screen", flush=True)
    rng = np.random.default_rng(1)
    qseq = "".join(AA[i] for i in rng.integers(0, 20, sz["query_len"]))
    seqs = ["".join(AA[i] for i in rng.integers(0, 20, sz["templ_len"]))
            for _ in range(sz["n_templates"])]
    names = [f"t{i}" for i in range(len(seqs))]
    qfa, lfa = os.path.join(tmp, "q.fa"), os.path.join(tmp, "lib.fa")
    _write_fasta(qfa, ["query"], [qseq])
    _write_fasta(lfa, names, seqs)
    k = sz["top_k"]
    argv = [qfa, lfa, "--SUB_MATRIX", BLOSUM, "--gap_init", "11",
            "--gap_extn", "1", "--top_k", str(k)]

    t0 = time.perf_counter()
    out = run_cli("screen", argv)
    report("aat_screen first run (compiles included)",
           time.perf_counter() - t0)
    t0 = time.perf_counter()
    out2 = run_cli("screen", argv)
    report("aat_screen warm run (screen + traceback + UPGMA)",
           time.perf_counter() - t0)
    check(out == out2, "aat_screen output is reproducible")
    cli_scores, cli_idx = parse_ranks(out)
    check(len(cli_idx) == k, f"aat_screen ranked {k} hits")
    check("# clusters" in out, "aat_screen clustered the hits")

    bl = BlosumMatrix(BLOSUM)
    table, pad_code = padded_table(bl)
    index = {c: i for i, c in enumerate(bl.alphabet)}
    q_codes = np.array([index[c] for c in qseq], np.int32)
    t_codes = encode_library(seqs, index, pad_code)
    gap = jnp.array([[11.0, 1.0]], jnp.float32)
    mesh = ps.grid_mesh((1, 1))
    engine = ps.pick_engine(mesh, 11.0, 1.0)
    print(f"  screen engine on this mesh: {engine}", flush=True)
    fn, args, _, _ = ps._screen_call(mesh, q_codes[None], t_codes, table,
                                     11.0, 1.0, k, engine)
    print(f"  screen step memory: "
          f"{fn.lower(*args).compile().memory_analysis()}", flush=True)
    full, ts, ti = (np.asarray(x)[0] for x in fn(*args))
    ref_full = ps.screen_grid(q_codes[None], t_codes, table, 11.0, 1.0,
                              k=k, mesh=mesh, engine="xla")[0][0]
    check(same_bits(full, ref_full),
          f"{engine} library scores == anti-diagonal XLA scores over "
          f"{len(full)} templates")
    order = np.lexsort((np.arange(len(full)), -full))[:k]
    check(np.array_equal(cli_idx, order) and same_bits(cli_scores,
                                                       full[order]),
          "aat_screen top hits == ranking of the library scores")
    seeded = rng.choice(len(seqs), sz["n_seeded"], replace=False)
    pick = np.concatenate([order, seeded])
    sim = table[q_codes][:, t_codes[pick]].transpose(1, 0, 2)
    check(same_bits(full[pick], swaffine.sw_affine_reference(sim, 11, 1)),
          f"scores == numpy Gotoh oracle on the top {k} and "
          f"{len(seeded)} seeded templates")

    # kernel-versus-XLA decision timings at the deployment width
    qd, td = jnp.asarray(q_codes), jnp.asarray(t_codes)
    tbl = jnp.asarray(table)
    cells = len(qseq) * t_codes.shape[0] * t_codes.shape[1]
    fns = {"strip kernel (Triton)":
           lambda: swscan.sw_strip_scores(qd, td, tbl, gap,
                                          interpret=not ps.on_gpu(mesh))
           .block_until_ready(),
           "plain lax row scan": lambda: swscan.sw_rowscan_scores_xla(
               qd, td, tbl, gap).block_until_ready()}
    for e in ps.SCREEN_ENGINES:
        fns[f"screen_library engine={e}"] = (
            lambda e=e: ps.screen_library(q_codes, t_codes, table, 11.0,
                                          1.0, k=k, mesh=ps.default_mesh(1),
                                          engine=e))
    for name, f in fns.items():
        med, spread = timed(f, sz["reps"])
        timings[name] = med
        print(f"time {name}: median {med:.6f} s, spread {spread:.6f} s, "
              f"{cells / med / 1e9:.1f} G cells/s ({CARD})", flush=True)
    rs = np.asarray(swscan.sw_rowscan_scores_xla(qd, td, tbl, gap))
    check(same_bits(rs, full), "plain lax row scan == strip kernel")

    # traceback of the top hits: device decode == host decode
    hits = np.argsort(-full, kind="stable")[:sz["tb_hits"]]
    hq = np.broadcast_to(q_codes, (len(hits), len(q_codes)))
    t0 = time.perf_counter()
    tb_scores, paths = swaffine.sw_affine_tb_batch(hq, t_codes[hits],
                                                   table, 11.0, 1.0)
    report(f"traceback of {len(hits)} hits (first call)",
           time.perf_counter() - t0)
    med, _ = timed(lambda: swaffine.sw_affine_tb_batch(
        hq, t_codes[hits], table, 11.0, 1.0), min(sz["reps"], 3))
    timings["traceback"] = med
    report(f"traceback of {len(hits)} hits x {len(q_codes)} (warm median)",
           med)
    check(same_bits(tb_scores, full[hits]),
          "traceback scores == screen scores")
    sd = swaffine.skewed_similarity_from_codes(
        jnp.asarray(hq), jnp.asarray(t_codes[hits]), tbl)
    tb, m, dat = swaffine.sw_affine_tb_xla(sd, gap, q=len(q_codes),
                                           t=t_codes.shape[1])
    _, host_paths = swaffine.decode_local_tracebacks(
        np.asarray(tb), np.asarray(m), np.asarray(dat), len(q_codes),
        t_codes.shape[1], nb=len(hits))
    check(paths == host_paths,
          "device-decoded paths == host decode_local_tracebacks")
    del jax


# ---------------------------------------------------------------------------
# phase 2: exact HMAP profile screen


def _profile_library(sz, tmp):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_profiles import make_profile
    rng = np.random.default_rng(2)
    qfn = os.path.join(tmp, "query.prof")
    with open(qfn, "w") as f:
        f.write(make_profile(rng, "query", sz["prof_query"]))
    d = os.path.join(tmp, "profiles")
    os.makedirs(d)
    lens = [sz["prof_lengths"][i % len(sz["prof_lengths"])]
            for i in range(sz["n_prof"])]
    rng.shuffle(lens)
    for i, n in enumerate(lens):
        with open(os.path.join(d, f"t{i:04d}.prof"), "w") as f:
            f.write(make_profile(rng, f"t{i}", int(n)))
    return qfn, d


def phase_profiles(sz, tmp, timings: dict) -> None:
    import glob

    import jax.numpy as jnp
    from alignment_algos_tpu.ops import dp_ref, dp_scores, hmap_device
    from alignment_algos_tpu.parallel import screen as ps
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.utils.params import AlignT, HMAPaliParams

    print("phase profiles", flush=True)
    qfn, d = _profile_library(sz, tmp)
    argv = [qfn, d, "--profiles", "1", "--top_k", str(sz["top_k"])]
    t0 = time.perf_counter()
    out = run_cli("screen", argv)
    report("aat_screen --profiles 1 first run (compiles included)",
           time.perf_counter() - t0)
    t0 = time.perf_counter()
    check(run_cli("screen", argv) == out, "profile screen is reproducible")
    timings["profile screen"] = time.perf_counter() - t0
    report("aat_screen --profiles 1 warm run", timings["profile screen"])
    cli_scores, cli_idx = parse_ranks(out)

    files = sorted(glob.glob(os.path.join(d, "*.prof")))
    query = HMAPSequence.from_file(qfn)
    templates = [HMAPSequence.from_file(fn) for fn in files]
    params = HMAPaliParams()
    ev = HMAPaliEval(params)
    factory = lambda q, t: HMAPaliEval(params)  # noqa: E731
    mesh = ps.default_mesh(1)
    engine = ps.profile_engine(mesh, ev)
    print(f"  profile engine on this mesh: {engine}", flush=True)
    dev_scores, dev_order = ps.screen_profiles(query, templates, factory,
                                               k=sz["top_k"])
    check(np.array_equal(cli_idx, dev_order)
          and [f"{v:g}" for v in cli_scores]
          == [f"{v:g}" for v in dev_scores[dev_order]],
          "aat_screen --profiles top hits == screen_profiles (as printed)")

    # device similarity == host build_costs, every template length
    qp = hmap_device.pack_sequence(query)
    lib = hmap_device.DeviceLibrary(templates, ev)
    for t2, b in sorted(lib.buckets.items()):
        S = np.asarray(hmap_device.build_similarity_device(
            jnp.asarray(qp["aa"]), jnp.asarray(qp["zsse"]),
            jnp.asarray(qp["conf"]), b["aa"], b["zsse"], b["conf"],
            jnp.float32(np.float32(params.alpha)),
            jnp.float32(np.float32(-np.float32(params.zero_shift))),
            jnp.uint32(0), q2=query.size(), t2=t2,
            normalize=bool(params.normalize_mtx)))
        ok = all(same_bits(S[j], ev.build_costs(query, templates[i]).S)
                 for j, i in enumerate(b["idx"]))
        check(ok, f"device similarity == host build_costs for all "
                  f"{len(b['idx'])} templates at q2={query.size()}, "
                  f"t2={t2}")

    host_scores, _ = ps.screen_profiles(query, templates, factory,
                                        k=sz["top_k"], engine="host")
    check(same_bits(dev_scores, host_scores),
          f"device-built screen == host cost builds, all "
          f"{len(templates)} templates")
    rng = np.random.default_rng(3)
    pick = np.concatenate([dev_order, rng.choice(len(templates),
                                                 sz["n_seeded"],
                                                 replace=False)])
    ref = []
    for i in pick:
        c = ev.build_costs(query, templates[i])
        ref.append(dp_ref.build_forward(c, 0, c.q_size - 1, 0,
                                        c.t_size - 1).H[-1, -1])
    check(same_bits(dev_scores[pick], np.array(ref, np.float32)),
          f"scores == host DP oracle on the top {sz['top_k']} and "
          f"{sz['n_seeded']} seeded templates")

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from util import random_costs
    for n in sz["dp_sizes"]:
        for at, vec, local in ((AlignT.SEMI_LOCAL, True, False),
                               (AlignT.GLOBAL, False, True)):
            rng = np.random.default_rng(n)
            cs = [random_costs(rng, n, n, at, at != AlignT.GLOBAL,
                               vectors=vec) for _ in range(2)]
            got = dp_scores.forward_scores_batch(cs, local=local)
            ref = np.array([dp_ref.build_forward(
                c, 0, n - 1, 0, n - 1, local=local).H[-1, -1] for c in cs],
                np.float32)
            check(same_bits(got, ref),
                  f"dp_scores == dp_ref at q2=t2={n} ({at.name}, "
                  f"{'vector' if vec else 'table'} D, local={local})")


# ---------------------------------------------------------------------------
# phase 3: exact pairwise alignment and near-optimal enumeration


def _strip_times(out: str) -> str:
    return "\n".join(line for line in out.splitlines()
                     if not line.startswith(("time for alignment",
                                             "total cpu time")))


def phase_pairwise(sz, tmp, timings: dict) -> None:
    from alignment_algos_tpu.core import dp

    print("phase pairwise", flush=True)
    rng = np.random.default_rng(4)
    fa = os.path.join(tmp, "pair.fa")
    with open(fa, "w") as f:
        for n in ("templ", "query"):
            s = "".join(AA[i] for i in rng.integers(0, 20, sz["pair_len"]))
            f.write(f"> {n}\n{s}\n")
    argv = [fa, "--SUB_MATRIX", BLOSUM, "--ALIGN_MODE", "1",
            "--NUM_SUBOPT", "20"]
    try:
        dp.set_backend("jax")
        run_cli("aaa", argv)                      # compile
        t0 = time.perf_counter()
        dev = run_cli("aaa", argv)
        timings["aaa device"] = time.perf_counter() - t0
        report(f"aaa {sz['pair_len']}x{sz['pair_len']} with the device "
               f"engine", timings["aaa device"])
        dp.set_backend("numpy")
        t0 = time.perf_counter()
        host = run_cli("aaa", argv)
        report("aaa with the host oracle", time.perf_counter() - t0)
        check(_strip_times(dev) == _strip_times(host),
              "aaa output (DP matrix, optimal and near-optimal "
              "alignments) is byte-equal to the host oracle's")
        dp.set_backend("jax")
        gold = os.path.join(ROOT, "tests", "golden")
        for pi, mode, extra in GOLDEN_AAA:
            out = run_cli("aaa", [
                os.path.join(gold, "inputs", f"aaa_pair{pi}.fa"),
                "--SUB_MATRIX", BLOSUM, "--ALIGN_MODE", str(mode),
                "--DELTA_RATIO", "0.25", "--NUM_SUBOPT", "20"] + extra)
            tag = "opt" if extra else "cw"
            with open(os.path.join(gold, f"aaa_p{pi}_m{mode}_{tag}.out")) as f:
                want = f.read()
            check(_strip_times(out) + "\n" == want,
                  f"golden aaa_p{pi}_m{mode}_{tag} with the device engine")
    finally:
        dp.set_backend("auto")


# ---------------------------------------------------------------------------
# four cards: the sharded paths against one card


def phase_cards(sz, tmp, n: int) -> None:
    import jax
    from alignment_algos_tpu.cli.screen import padded_table
    from alignment_algos_tpu.parallel import screen as ps
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.scoring.submatrix import BlosumMatrix
    from alignment_algos_tpu.utils.params import HMAPaliParams

    print(f"phase cards ({n} devices)", flush=True)
    table, _ = padded_table(BlosumMatrix(BLOSUM))
    rng = np.random.default_rng(5)
    q = rng.integers(0, 20, sz["query_len"]).astype(np.int32)
    lib = rng.integers(0, 20, (sz["n_templates"], sz["templ_len"])
                       ).astype(np.int32)
    k = sz["top_k"]
    one = ps.default_mesh(1)
    many = ps.default_mesh(n)
    for name, mesh in (("1 card", one), (f"{n} cards", many)):
        med, _ = timed(lambda m=mesh: ps.screen_library(
            q, lib, table, 11.0, 1.0, k=k, mesh=m), sz["reps"])
        report(f"screen_library on {name}", med)
    s1, i1 = ps.screen_library(q, lib, table, 11.0, 1.0, k=k, mesh=one)
    sn, i_n = ps.screen_library(q, lib, table, 11.0, 1.0, k=k, mesh=many)
    check(np.array_equal(i1, i_n) and same_bits(s1, sn),
          f"screen_library on {n} cards == 1 card (top {k})")

    grid = ps.grid_mesh((2, n // 2))
    fn, args, _, _ = ps._screen_call(grid, lib[:sz["grid_queries"],
                                              :sz["query_len"]],
                                     lib, table, 11.0, 1.0, k,
                                     ps.pick_engine(grid, 11.0, 1.0))
    devs = {sh.device for a in args[:2] for sh in a.addressable_shards}
    check(len(devs) == n, f"the grid screen's inputs span all {n} cards")
    qs = lib[:sz["grid_queries"], :sz["query_len"]]
    sg, tsg, tig = ps.screen_grid(qs, lib, table, 11.0, 1.0, k=k,
                                  mesh=grid)
    s1g, ts1, ti1 = ps.screen_grid(qs, lib, table, 11.0, 1.0, k=k,
                                   mesh=ps.grid_mesh((1, 1)))
    check(same_bits(sg, s1g) and np.array_equal(tig, ti1)
          and same_bits(tsg, ts1),
          f"screen_grid on a (2, {n // 2}) mesh with {len(qs)} queries == "
          f"1 card")

    qfn, d = _profile_library(dict(sz, n_prof=max(sz["n_prof"] // 4, 8)),
                              tmp)
    import glob
    query = HMAPSequence.from_file(qfn)
    templates = [HMAPSequence.from_file(fn)
                 for fn in sorted(glob.glob(os.path.join(d, "*.prof")))]
    params = HMAPaliParams()
    factory = lambda a, b: HMAPaliEval(params)  # noqa: E731
    s_one, o_one = ps.screen_profiles(query, templates, factory, k=k,
                                      engine="host")
    s_many, o_many = ps.screen_profiles(query, templates, factory, k=k,
                                        mesh=many)
    check(same_bits(s_one, s_many) and np.array_equal(o_one, o_many),
          f"screen_profiles sharded over {n} cards == unsharded "
          f"({len(templates)} templates)")
    stats = [dev.memory_stats() for dev in jax.devices()[:n]]
    if all(stats):      # the CPU backend keeps none
        peaks = [st.get("peak_bytes_in_use", 0) for st in stats]
        print(f"  peak bytes in use per card: {peaks}", flush=True)
        check(all(p > 0 for p in peaks), f"all {n} cards held work")


# ---------------------------------------------------------------------------


def card_name() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def native_engines() -> dict:
    from alignment_algos_tpu import native
    from alignment_algos_tpu.analysis import ali_dist
    from alignment_algos_tpu.core.enumerators import native as enum_native
    from alignment_algos_tpu.ops import dp_ref
    from alignment_algos_tpu.ssss import native_search
    return {"exactmath": native._load() is not None,
            "dpref": dp_ref._load_native() is not None,
            "alidist": ali_dist._load_native() is not None,
            "enumerate": enum_native.load() is not None,
            "ssss_search": native_search._load() is not None}


def run(sz, cards: int = 1) -> dict:
    """Every phase at sizes ``sz`` (FULL or SMALL); raises SmokeFailure on
    the first failed check.  Returns the timings."""
    timings: dict = {}
    home = os.environ.get("HOME")
    with tempfile.TemporaryDirectory() as tmp:
        # no ~/.hmaprc may change the CLIs' defaults
        os.environ["HOME"] = os.path.join(tmp, "home")
        try:
            if cards > 1:
                phase_cards(sz, tmp, cards)
            else:
                phase_screen(sz, tmp, timings)
                phase_profiles(sz, tmp, timings)
                phase_pairwise(sz, tmp, timings)
        finally:
            if home is None:
                os.environ.pop("HOME", None)
            else:
                os.environ["HOME"] = home
    return timings


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from alignment_algos_tpu.utils.jaxenv import setup_jax
    setup_jax()
    import jax
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform})",
              file=sys.stderr)
        return 1
    if len(devs) < args.cards:
        print(f"chip_smoke: {args.cards} cards asked, {len(devs)} present",
              file=sys.stderr)
        return 1
    CARD = card_name()
    print(f"devices: {dev.platform} {dev.device_kind} x {len(devs)}")
    print(f"card: {CARD}")
    print(f"native engines: {native_engines()}", flush=True)
    t0 = time.perf_counter()
    try:
        run(FULL, args.cards)
    except Exception as e:  # noqa: BLE001 - any failure fails the smoke
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    report("chip_smoke total", time.perf_counter() - t0)
    print(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
