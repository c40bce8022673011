from .cg import solve_cg
from .cg_fused import solve_cg_fused
from .cg_merged import solve_cg_merged
from .control import (
    IterationNumberControl,
    NoConvergence,
    ReductionControl,
    SolverControl,
)

__all__ = [
    "SolverControl",
    "IterationNumberControl",
    "ReductionControl",
    "NoConvergence",
    "solve_cg",
    "solve_cg_fused",
    "solve_cg_merged",
]
