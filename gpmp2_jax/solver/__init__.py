"""Block-tridiagonal Gauss-Newton/LM/Dogleg solver (replaces GTSAM elimination)."""

from .blocktridiag import batched_block_tridiag_solve, block_tridiag_solve
from .optimize import OptimizerParams, OptResult, optimize_batch
from .partitioned import (
    block_tridiag_solve_partitioned,
    block_tridiag_solve_ts_sharded,
)

__all__ = [
    "batched_block_tridiag_solve", "block_tridiag_solve", "OptimizerParams", "OptResult", "optimize_batch",
    "block_tridiag_solve_partitioned", "block_tridiag_solve_ts_sharded",
]
