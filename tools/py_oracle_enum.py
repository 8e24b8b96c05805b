#!/usr/bin/env python3
"""Python twin of tools/oracle_enum.cpp: run our enumerators with HMAPaliEval
on two .prof files and print each alignment as 'score <tab> (q,t) pairs'."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alignment_algos_tpu.utils.jaxenv import setup_jax

setup_jax()

from alignment_algos_tpu.core.alignment import AlignmentSet
from alignment_algos_tpu.core.dp import DPMatrix
from alignment_algos_tpu.core.enumerators import (
    ConstrainedNearOptimal, CRConstrainedNearOptimal,
    KSConstrainedNearOptimal, Optimal, UnconstrainedNearOptimal)
from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
from alignment_algos_tpu.seq.hmap import HMAPSequence
from alignment_algos_tpu.seq.sflags import SuboptFlags
from alignment_algos_tpu.utils.params import Argv, HMAPaliParams


def main(argv) -> int:
    args = Argv(argv)
    mode = args.get_arg(0)
    query = HMAPSequence.from_file(args.get_arg(1))
    templ = HMAPSequence.from_file(args.get_arg(2))
    params = HMAPaliParams()
    params.read(args)

    subopt = SuboptFlags(True, templ.size())
    templ.get_default_flags(subopt)
    if args.count() > 3:
        fs = args.get_arg(3)
        for i, ch in enumerate(fs[: subopt.size()]):
            subopt.set(i, ch != "0")

    ge = HMAPaliEval(params)
    dpm = DPMatrix(query, templ, ge, "fwd", params.align_type)
    as_ = AlignmentSet(dpm, Optimal(params.align_type))

    enum = {
        "cw": lambda: ConstrainedNearOptimal(params, subopt),
        "ucw": lambda: UnconstrainedNearOptimal(params),
        "kscw": lambda: KSConstrainedNearOptimal(params, subopt),
        "crcw": lambda: CRConstrainedNearOptimal(params, subopt),
    }[mode]()
    enum.enumerate(dpm, as_)

    out = []
    for a in as_:
        pairs = "".join(f"({q},{t})" for q, t in a.pairs)
        out.append(f"{a.score:.6g}\t{pairs}")
    print("\n".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
