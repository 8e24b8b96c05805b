"""Checkpoint/resume for long library screens (net-new; the reference has
no checkpointing at all — SURVEY.md section 5 "Checkpoint/resume: none" —
every run rebuilds all state from input files).

A production screen walks a template library far larger than device memory
in chunks; losing a multi-hour sweep to a preemption is unacceptable on
shared accelerators.  This module makes the sweep restartable: after each chunk
the running global top-k and the set of completed chunks are written
atomically (tmp + rename) to a single ``.npz``.  Resuming skips completed
chunks and reproduces bit-identical results, because the merge is the same
deterministic ranking the in-memory path uses (score descending, template
id ascending — the sortSet semantics, alignment.h:922-932).
"""

from __future__ import annotations

import os

import numpy as np

from .screen import screen_library


def _merge_topk(scores_a, idx_a, scores_b, idx_b, k: int):
    """Deterministic top-k merge: score desc, ties by template id asc."""
    scores = np.concatenate([scores_a, scores_b])
    idx = np.concatenate([idx_a, idx_b])
    order = np.lexsort((idx, -scores))[:k]
    return scores[order], idx[order]


class ScreenCheckpoint:
    """On-disk state of a chunked screen: done-chunk bitmap + running top-k."""

    def __init__(self, path: str, n_chunks: int, k: int):
        self.path = path
        self.n_chunks = n_chunks
        self.done = np.zeros(n_chunks, dtype=bool)
        self.scores = np.empty(0, dtype=np.float32)
        self.idx = np.empty(0, dtype=np.int64)
        self.k = k

    @classmethod
    def load_or_create(cls, path: str, n_chunks: int, k: int):
        self = cls(path, n_chunks, k)
        if path and os.path.exists(path):
            with np.load(path) as z:
                if int(z["n_chunks"]) != n_chunks or int(z["k"]) != k:
                    raise ValueError(
                        f"checkpoint {path} was written for a different "
                        f"screen shape (n_chunks={int(z['n_chunks'])}, "
                        f"k={int(z['k'])}); delete it or change the path")
                self.done = z["done"]
                self.scores = z["scores"]
                self.idx = z["idx"]
        return self

    def record(self, chunk: int, scores, idx) -> None:
        self.scores, self.idx = _merge_topk(self.scores, self.idx,
                                            scores, idx, self.k)
        self.done[chunk] = True
        self.save()

    def save(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        np.savez(tmp, done=self.done, scores=self.scores, idx=self.idx,
                 n_chunks=self.n_chunks, k=self.k)
        # np.savez appends .npz to names without it
        if not tmp.endswith(".npz"):
            tmp += ".npz"
        os.replace(tmp, self.path)


def screen_library_checkpointed(q_codes, t_codes, table, gi: float, ge: float,
                                k: int = 10, chunk_size: int = 1024,
                                ckpt_path: str = "", mesh=None,
                                max_chunks: int | None = None,
                                engine: str | None = None):
    """Resumable chunked screen of one query against a template library.

    Same result as ``screen_library`` (global top-k with deterministic
    tie-breaking), but processed ``chunk_size`` templates at a time with the
    running state checkpointed to ``ckpt_path`` after every chunk.  A rerun
    with the same arguments resumes where the previous run stopped.

    ``max_chunks`` bounds how many *incomplete* chunks this call processes
    (for cooperative preemption / tests); the return value is the running
    top-k, complete only when ``all_done`` is True.

    Returns (scores, indices, all_done).
    """
    t_codes = np.asarray(t_codes)
    n = t_codes.shape[0]
    n_chunks = -(-n // chunk_size)
    k_eff = min(k, n)
    ckpt = ScreenCheckpoint.load_or_create(ckpt_path, n_chunks, k_eff)

    processed = 0
    for c in range(n_chunks):
        if ckpt.done[c]:
            continue
        if max_chunks is not None and processed >= max_chunks:
            break
        lo, hi = c * chunk_size, min((c + 1) * chunk_size, n)
        scores, idx = screen_library(q_codes, t_codes[lo:hi], table, gi, ge,
                                     k=min(k_eff, hi - lo), mesh=mesh,
                                     engine=engine)
        ckpt.record(c, scores.astype(np.float32), idx.astype(np.int64) + lo)
        processed += 1

    return ckpt.scores, ckpt.idx, bool(ckpt.done.all())
