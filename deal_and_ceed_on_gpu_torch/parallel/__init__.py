"""Distribution over ranks on ``torch.distributed``: block partitions, the
halo exchange, the distributed operators (cell loops, K1, K2, K4) and
solvers. Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/``."""

from .comm import ShardComm, init_shards, spawn
from .dist_banded import DistBandedOperator
from .dist_operator import DistOperator, DistPoissonOperator, halo_combine
from .dist_solve import make_dist_solver, make_dist_vmult, solve_cg_dist, solve_cg_merged_dist
from .dist_stencil import DistStencilOperator
from .partition import BlockPartition, SlabPartition

__all__ = [
    "BlockPartition",
    "DistBandedOperator",
    "DistOperator",
    "DistPoissonOperator",
    "DistStencilOperator",
    "ShardComm",
    "SlabPartition",
    "halo_combine",
    "init_shards",
    "make_dist_solver",
    "make_dist_vmult",
    "solve_cg_dist",
    "solve_cg_merged_dist",
    "spawn",
]
