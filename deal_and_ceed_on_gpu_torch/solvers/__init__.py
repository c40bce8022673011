from .cg import solve_cg
from .cg_fused import solve_cg_fused
from .cg_merged import solve_cg_merged
from .fdm import FDMSolver
from .ir import solve_cg_ir
from .multigrid import Multigrid
from .adaptive_mg import AdaptiveMultigrid
from .control import (
    IterationNumberControl,
    NoConvergence,
    ReductionControl,
    SolverControl,
)

__all__ = [
    "FDMSolver",
    "Multigrid",
    "AdaptiveMultigrid",
    "SolverControl",
    "IterationNumberControl",
    "ReductionControl",
    "NoConvergence",
    "solve_cg",
    "solve_cg_fused",
    "solve_cg_merged",
    "solve_cg_ir",
]
