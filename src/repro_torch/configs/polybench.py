"""The paper's own workload: Polybench block-programs (3MM, GEMM, ...).

Not an LM architecture — these are the offload programs used by the paper's
Tables/Figures; see ``repro_torch.polybench`` for the program builders and
``benchmarks/`` for the speedup comparisons.
"""
POLYBENCH_PROBLEMS = (
    "2mm", "3mm", "gemm", "atax", "bicg", "mvt", "gesummv", "syrk",
    "covariance", "jacobi2d",
)
