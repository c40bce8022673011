"""Distribution over ranks on ``torch.distributed``: block partitions, the
halo exchange, the distributed operators (cell loops, K1, K2, K4) and
solvers, the distributed FDM and multigrid, and the adaptive meshes over
owned slabs (the operator on K4, adaptive multigrid, the AMR loop).
Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/``."""

from .comm import ShardComm, SlabComm, init_shards, spawn
from .dist_adaptive import AdaptivePartition, DistAdaptivePoisson, solve_cg_merged_dist_adaptive
from .dist_adaptive_mg import DistAdaptiveMultigrid, solve_cg_mg_dist_adaptive
from .dist_amr import amr_loop_distributed, estimate_gradient_recovery_dist
from .dist_banded import DistBandedOperator
from .dist_fdm import DistFDM, solve_cg_fdm_dist
from .dist_multigrid import DistMultigrid, solve_cg_mg_dist
from .dist_operator import DistOperator, DistPoissonOperator, halo_combine
from .dist_solve import make_dist_solver, make_dist_vmult, solve_cg_dist, solve_cg_merged_dist
from .dist_stencil import DistStencilOperator
from .partition import BlockPartition, SlabPartition

__all__ = [
    "AdaptivePartition",
    "BlockPartition",
    "DistAdaptiveMultigrid",
    "DistAdaptivePoisson",
    "DistBandedOperator",
    "DistFDM",
    "DistMultigrid",
    "DistOperator",
    "DistPoissonOperator",
    "DistStencilOperator",
    "ShardComm",
    "SlabComm",
    "SlabPartition",
    "amr_loop_distributed",
    "estimate_gradient_recovery_dist",
    "halo_combine",
    "init_shards",
    "make_dist_solver",
    "make_dist_vmult",
    "solve_cg_dist",
    "solve_cg_fdm_dist",
    "solve_cg_merged_dist",
    "solve_cg_merged_dist_adaptive",
    "solve_cg_mg_dist",
    "solve_cg_mg_dist_adaptive",
    "spawn",
]
