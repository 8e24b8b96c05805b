"""``aat_screen`` — sharded template-library screen (net-new scale-out
tool; the reference is single-threaded with no screening driver,
SURVEY.md §2.10).

One query FASTA sequence is screened against every sequence of a library
FASTA with the batched affine-gap Smith-Waterman engines, the library
sharded over the device mesh (`parallel/screen.py`: per-shard scoring,
top-k merge across shards with deterministic score-desc/index-asc ties).
The top-K hits' optimal alignments then come off the device in one
traceback batch and are UPGMA-clustered on the reference ali_dist area
metric over the shared query axis (BASELINE.md configs 2 and 5).

    aat_screen query.fa library.fa [--top_k 10] [--gap_init 11]
               [--gap_extn 1] [--SUB_MATRIX BLOSUM62]
               [--cluster_threshold 8.0] [--ckpt state.npz]
               [--chunk_size 1024]

Variable-length templates are padded in-batch with a 21st "pad" code whose
substitution score is a large negative wall: a local alignment can neither
cross nor profit from it, so padded scores equal unpadded ones.

With ``--ckpt`` the screen runs in resumable chunks: the running top-k and
completed-chunk bitmap persist after every chunk, so a preempted run
re-invoked with the same arguments continues where it stopped.
"""

from __future__ import annotations

import sys

import numpy as np

from ..scoring.submatrix import BlosumMatrix
from ..utils.params import AliParams, ApplicationParams, Argv, RCfile, \
    apply_layers

PAD_WALL = -1.0e4


def read_fasta_plain(fn: str) -> list[tuple[str, str]]:
    """[(name, residues)] — plain multi-FASTA, no sentinels."""
    out: list[tuple[str, str]] = []
    name = None
    chunks: list[str] = []
    with open(fn) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name = line[1:].strip() or f"seq_{len(out)}"
                chunks = []
            elif line:
                chunks.append(line.replace(" ", ""))
    if name is not None:
        out.append((name, "".join(chunks)))
    if not out:
        raise ValueError(f"no sequences in {fn}")
    return out


def encode_library(seqs: list[str], index: dict[str, int], pad_code: int):
    """Pad-encode to (N, Tmax) int32 with the pad wall code."""
    tmax = max(len(s) for s in seqs)
    codes = np.full((len(seqs), tmax), pad_code, dtype=np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = [index[c] for c in s.upper()]
    return codes


def padded_table(bl: BlosumMatrix):
    """Substitution table extended with a pad row/col of PAD_WALL."""
    n = len(bl.alphabet)
    t = np.full((n + 1, n + 1), PAD_WALL, dtype=np.float32)
    t[:n, :n] = bl.matrix
    return t, n  # pad code = n


def main(argv=None) -> int:
    from ..utils.jaxenv import setup_jax
    setup_jax()
    argv = argv if argv is not None else sys.argv[1:]
    try:
        return _run(argv)
    except (ValueError, OSError) as e:
        print(e, file=sys.stderr)
        return -1


def _run(argv) -> int:
    args = Argv(argv)
    if args.dohelp or args.count() < 2:
        print("Usage: aat_screen query.fa library.fa [--top_k N "
              "--gap_init F --gap_extn F --SUB_MATRIX file "
              "--cluster_threshold F --ckpt file --chunk_size N]",
              file=sys.stderr)
        return 0

    ali_params = AliParams()
    app_params = ApplicationParams()
    rc = RCfile()
    topfile = ""
    if args.get_switch("-top", erase=False):
        topfile = args.get_switch_arg("-top", 1)
    top = RCfile(topfile) if topfile else None
    apply_layers([ali_params, app_params], rc, top, args)

    k = args.get_int("top_k", 10)
    gi = args.get_float("gap_init", ali_params.gap_init_penalty)
    ge = args.get_float("gap_extn", ali_params.gap_extn_penalty)
    # UPGMA cut on the ali_dist area metric: average |query-template shift|
    # in residues between two hits' alignments (ali_dist.cpp:633-638 scale)
    thresh = args.get_float("cluster_threshold", 8.0)
    ckpt = args.get_str("ckpt", "")
    chunk = args.get_int("chunk_size", 1024)
    if args.get_int("profiles", 0) == 1:
        return _run_profiles(args, k, rc, top)  # needs no submatrix
    if args.get_int("smap", 0) == 1:
        return _run_profiles(args, k, rc, top, smap=True)  # fold recognition

    if not ali_params.submatrix_fn:
        raise ValueError("no substitution matrix: pass --SUB_MATRIX <file> "
                         "or set SUB_MATRIX in ~/.hmaprc / -top file")

    query_name, query_seq = read_fasta_plain(args.get_arg(0))[0]
    library = read_fasta_plain(args.get_arg(1))
    names = [n for n, _ in library]
    seqs = [s for _, s in library]

    bl = BlosumMatrix(ali_params.submatrix_fn)
    table, pad_code = padded_table(bl)
    index = {c: i for i, c in enumerate(bl.alphabet)}
    q_codes = np.asarray([index[c] for c in query_seq.upper()], dtype=np.int32)
    t_codes = encode_library(seqs, index, pad_code)

    from ..parallel import screen as pscreen
    if ckpt:
        from ..parallel.checkpoint import screen_library_checkpointed
        scores, idx, done = screen_library_checkpointed(
            q_codes, t_codes, table, gi, ge, k=k, chunk_size=chunk,
            ckpt_path=ckpt)
        if not done:
            print("screen incomplete (resume with the same command)",
                  file=sys.stderr)
    else:
        scores, idx = pscreen.screen_library(q_codes, t_codes, table, gi, ge,
                                             k=k)

    print(f"# query: {query_name} ({len(query_seq)} aa) vs "
          f"{len(library)} templates; top {len(idx)}")
    print("# rank\tscore\tindex\tname")
    for r, (s, i) in enumerate(zip(scores, idx), start=1):
        print(f"{r}\t{s:g}\t{int(i)}\t{names[int(i)]}")

    if len(idx) >= 2:
        _cluster_hits(q_codes, t_codes, table, gi, ge, scores, idx, names,
                      thresh, pad_code)
    return 0


def _run_profiles(args, k: int, rc=None, top=None,
                  smap: bool = False) -> int:
    """``--profiles 1``: query.prof vs a directory (or list file) of .prof
    templates, scored with the exact HMAP profile-profile evaluator
    (position-specific gaps, z-normalized similarity — the nalign scoring
    path) through the batched general-gap engine.

    ``--smap 1``: fold recognition — the templates are SMAP structure
    profiles (``PDB:`` header) scored with the full Gn2Eval structure-aware
    model (distance-gated deletions, H-bond and contact-number terms — the
    gn2 scoring path) at library scale."""
    import glob
    import os

    from ..seq.hmap import HMAPSequence
    from ..parallel.screen import screen_profiles

    query = HMAPSequence.from_file(args.get_arg(0))
    lib_arg = args.get_arg(1)
    if os.path.isdir(lib_arg):
        files = sorted(glob.glob(os.path.join(lib_arg, "*.prof")))
    else:
        with open(lib_arg) as f:
            files = [l.strip() for l in f if l.strip()]
    if not files:
        raise ValueError(f"no template profiles found in {lib_arg}")

    if smap:
        from ..scoring.gn2_eval import Gn2Eval, Gn2Params
        from ..structure.smap import SMAPSequence
        templates = [SMAPSequence.from_file(fn, gn2=True) for fn in files]
        params = Gn2Params()
        apply_layers([params], rc, top, args)
        factory = lambda q, t: Gn2Eval(params)
        kind = "SMAP structure"
    else:
        from ..scoring.hmap_eval import HMAPaliEval, HMAPaliParams
        templates = [HMAPSequence.from_file(fn) for fn in files]
        params = HMAPaliParams()
        apply_layers([params], rc, top, args)
        factory = lambda q, t: HMAPaliEval(params)
        kind = "template"

    # several devices: shard the bucket batches over all of them
    # (bit-identical to one device; parallel/screen._sharded_bucket_scores)
    import jax

    from ..parallel.screen import default_mesh
    mesh = default_mesh() if len(jax.devices()) > 1 else None
    scores, order = screen_profiles(query, templates, factory, k=k, mesh=mesh)
    print(f"# query profile vs {len(templates)} {kind} profiles; "
          f"top {len(order)}")
    print("# rank\tscore\tindex\tfile")
    for r, i in enumerate(order, start=1):
        print(f"{r}\t{scores[int(i)]:g}\t{int(i)}\t{files[int(i)]}")
    return 0


def _cluster_hits(q_codes, t_codes, table, gi, ge, scores, idx, names,
                  thresh: float, pad_code: int) -> None:
    """Cluster the top hits by the reference alignment-distance metric
    (BASELINE config 2 distance matrix + config 5 clustering).

    Every hit's optimal local SW alignment against the query comes off the
    device in one traceback batch (the batched analogue of
    optimal.h:47-124); each alignment is a polyline over the shared query
    axis, and the hit-hit distance is Ali_Dist's exact area between the two
    polylines divided by the query length (ali_dist.cpp:160-414,633-638) —
    the real area metric, via the native all-pairs engine."""
    from ..analysis.ali_dist import ResPair, area_matrix
    from ..analysis.upgma import UPGMAClusterer
    from ..ops import swaffine

    hits = t_codes[np.asarray(idx, dtype=np.int64)]
    n = len(hits)
    qlen = q_codes.shape[0]
    tlens = (hits != pad_code).sum(axis=1)
    qb = np.broadcast_to(q_codes, (n, qlen))
    _, paths = swaffine.sw_affine_tb_batch(qb, hits, table, gi, ge)

    # polylines in Ali_Dist's (t, q) convention with the QUERY as the
    # shared t axis, 1-based and sentinel-anchored at both ends exactly as
    # strings_to_vrp renders the '^'/'$' matches
    vrps = [
        [ResPair(0, 0)]
        + [ResPair(qi + 1, ti + 1) for qi, ti in p]
        + [ResPair(qlen + 1, int(tlens[b]) + 1)]
        for b, p in enumerate(paths)
    ]
    dist = np.asarray(area_matrix(vrps), dtype=np.float64) / float(qlen)

    clusterer = UPGMAClusterer(dist)
    clusterer.cluster()
    clusters = clusterer.find_clusters_under_threshold(thresh)
    print(f"# clusters (UPGMA cut at {thresh:g}): {len(clusters)}")
    for ci, members in enumerate(clusters, start=1):
        label = ", ".join(names[int(idx[m])] for m in members)
        print(f"cluster {ci}: {label}")


if __name__ == "__main__":
    sys.exit(main())
