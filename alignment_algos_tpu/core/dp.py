"""DP matrix orchestration (DPMatrix in dpmatrix.h).

Holds the sequences, evaluator, direction and alignment type; materializes
the evaluator's cost model once, then runs either the device engine
(ops.dp_engine) or the host oracle (ops.dp_ref) to produce scores plus a full
traceback.  ``reevaluate`` rebuilds the cost model and re-runs the same
jitted kernel — the cheap-rebuild path used by gn2's iterative rounds
(dpmatrix.h:213-218).
"""

from __future__ import annotations

import os

import numpy as np

from ..scoring.base import DPCosts
from ..utils.params import AlignT
from ..ops import dp_ref

FWD = "fwd"
REV = "rev"

# backend: "jax" (device engine), "numpy" (host oracle), or "auto"
_BACKEND = os.environ.get("AAT_DP_BACKEND", "auto")
_AUTO_MIN_SIZE = 40  # below this, host oracle beats kernel dispatch overhead


def set_backend(name: str) -> None:
    global _BACKEND
    assert name in ("jax", "numpy", "auto")
    _BACKEND = name


def _use_jax(q2: int, t2: int) -> bool:
    if _BACKEND == "jax":
        return True
    if _BACKEND == "numpy":
        return False
    return max(q2, t2) >= _AUTO_MIN_SIZE


class DPMatrix:
    def __init__(self, query_seq, templ_seq, evaluator, direction: str = FWD,
                 align_type: AlignT = AlignT.GLOBAL,
                 sub_bounds: tuple[int, int, int, int] | None = None,
                 bug_compat: bool = True) -> None:
        self.query_seq = query_seq
        self.templ_seq = templ_seq
        self.evaluator = evaluator
        self.direction = direction
        self.align_type = AlignT(align_type)
        self.islocal = self.align_type == AlignT.LOCAL
        self.sub_bounds = sub_bounds  # (q1_end, t1_end, q2_beg, t2_beg)
        self.bug_compat = bug_compat
        self.costs: DPCosts | None = None
        self.res: dp_ref.DPResult | None = None
        self._build()

    # --- reference-compatible accessors -----------------------------------
    def get_query_size(self) -> int:
        return self.query_seq.size()

    def get_template_size(self) -> int:
        return self.templ_seq.size()

    def get_cell(self, i: int, j: int) -> tuple[float, int, int]:
        """(score, prev_query_idx, prev_template_idx)."""
        return (float(self.res.H[i, j]), int(self.res.PQ[i, j]),
                int(self.res.PT[i, j]))

    def score(self, i: int, j: int) -> float:
        return float(self.res.H[i, j])

    def prev(self, i: int, j: int) -> tuple[int, int]:
        return int(self.res.PQ[i, j]), int(self.res.PT[i, j])

    def get_sim(self, i: int, j: int) -> float:
        return float(self.costs.S[i, j])

    def deletion(self, q1: int, q2: int, t1: int, t2: int) -> float:
        return self.costs.deletion(q1, q2, t1, t2)

    def insertion(self, q1: int, q2: int, t1: int, t2: int) -> float:
        return self.costs.insertion(q1, q2, t1, t2)

    def set_evaluator(self, evaluator, direction: str) -> None:
        self.evaluator = evaluator
        self.direction = direction
        self.reevaluate()

    def reevaluate(self) -> None:
        self._build()

    # ----------------------------------------------------------------------
    def _build(self) -> None:
        self.costs = self.evaluator.build_costs(self.query_seq, self.templ_seq)
        c = self.costs
        q2, t2 = c.q_size, c.t_size
        if self.sub_bounds is not None:
            q0, t0, q1, t1 = self.sub_bounds
        else:
            q0, t0, q1, t1 = 0, 0, q2 - 1, t2 - 1

        # constant-affine integer cost models (the substitution
        # evaluators) take the O(Q*T) prefix-max fast path — byte-equal
        # to dp_ref (ops/dp_affine; round 5), ~(Q+T)x less work than the
        # general candidate-scan engines
        if self.direction == FWD and self.sub_bounds is None:
            from ..ops import dp_affine
            aff = dp_affine.affine_consts(c)
            if aff is not None:
                self.res = dp_affine.build_forward_affine(
                    c, q0, q1, t0, t1, aff[0], aff[1], local=self.islocal)
                return

        # route on the EFFECTIVE rectangle: SSSS loop fills are tiny
        # sub-builds of big sequences, and every distinct sub-bounds tuple
        # would otherwise trigger a fresh XLA compile (~1 s) that dwarfs the
        # host build (profiled: 94% of SSSS enumerate time was compilation)
        if _use_jax(q1 - q0 + 1, t1 - t0 + 1):
            from ..ops import dp_engine
            if self.direction == FWD:
                self.res = dp_engine.build_forward_jax(
                    c, q0, q1, t0, t1, local=self.islocal)
            else:
                self.res = dp_engine.build_reverse_jax(
                    c, q0, q1, t0, t1, local=self.islocal,
                    bug_compat=self.bug_compat)
        else:
            if self.direction == FWD:
                self.res = dp_ref.build_forward(c, q0, q1, t0, t1,
                                                local=self.islocal)
            else:
                self.res = dp_ref.build_reverse(c, q0, q1, t0, t1,
                                                local=self.islocal,
                                                bug_compat=self.bug_compat)

    def dump_matrix(self) -> str:
        """operator<< on DPMatrix (dpmatrix.h:116-129): tab-separated scores."""
        lines = []
        for i in range(self.get_query_size()):
            lines.append("\t".join(_fmt_g6(v) for v in self.res.H[i]) + "\t")
        return "\n".join(lines) + "\n"


def _fmt_g6(v: float) -> str:
    """C++ ostream default formatting (6 significant digits, %g-style)."""
    s = f"{float(v):.6g}"
    return s
