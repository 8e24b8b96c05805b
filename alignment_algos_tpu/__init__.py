"""alignment_algos_tpu — an exact protein sequence-structure alignment engine in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the capabilities of the
HMAP2.1 C++ library (christang/alignment-algos): generic dynamic-programming
alignment with pluggable scoring evaluators, optimal and near-optimal
alignment enumeration, fragment-graph (SSSS) enumeration, alignment-distance
metrics, clustering, and the supporting profile/PDB/FASTA/PIR I/O and layered
parameter system.

Layout
------
utils/      config stack (ParamStore / RCfile / Argv equivalents), math helpers
seq/        sequence model (AA, HMAP profile, SMAP structure profile, flags)
scoring/    evaluators (BLOSUM substitution, HMAP, HMAP2, GN2, GNOALI)
ops/        device engines (exact general-gap DP, batched affine SW, the Triton screen kernel)
core/       DP matrix orchestration, alignments, enumerators
structure/  PDB parsing + derived structural features (replaces trollbase)
ssss/       fragment-graph near-optimal enumerator
analysis/   alignment distance, UPGMA / k-medoids clustering, shift metrics
io/         FASTA / PIR / HMAP rendering and parsing
parallel/   device-mesh scale-out (pjit query streaming, sharded screens)
cli/        command-line tools mirroring the reference tool suite
"""

__version__ = "0.1.0"
