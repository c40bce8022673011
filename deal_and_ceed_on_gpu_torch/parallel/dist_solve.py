"""Distributed CG solves: every rank runs the solver loop on its block.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/dist_solve.py``: the
port's ``solvers.cg*`` with a distributed operator (``DistOperator``,
``DistStencilOperator`` or ``DistBandedOperator``), its dot weights and its
``ShardComm``. An iteration is (local update) -> (local apply + plane
exchanges) -> (local dots + one all-reduce of the stacked seven, merged CG);
the scalar recurrences run on every rank on the same all-reduced bits, so
every rank takes the same branch and stops at the same iteration (the
reference's 7-double ``MPI_Allreduce`` and host scalar math,
``bp5/solver.h:488-533``). Eager torch does not retrace, so no solver cache
is kept.
"""

from __future__ import annotations

import torch

from ..solvers.cg import solve_cg
from ..solvers.cg_merged import solve_cg_merged
from ..solvers.control import SolverControl

__all__ = ["make_dist_solver", "make_dist_vmult", "solve_cg_dist", "solve_cg_merged_dist"]


def make_dist_vmult(dist_op):
    """The rank's apply ``u_local -> (A u)_local`` (the distributed vmult mode)."""
    return dist_op.vmult


def make_dist_solver(solver_fn, dist_op, control: SolverControl, **kwargs):
    """``run(b_local, diag_local=None) -> (x_local, info)``: ``solver_fn``
    (``solve_cg`` or ``solve_cg_merged``) on the rank's block. With vectors
    stored below the compute dtype (bf16) the dots accumulate at the compute
    dtype unless ``dot_dtype`` is given."""
    stream = getattr(dist_op, "stream_dtype", None)
    compute = getattr(dist_op, "dtype", None)
    if stream is not None and stream != compute:
        kwargs.setdefault("dot_dtype", compute)

    def run(b_local: torch.Tensor, diag_local: torch.Tensor | None = None):
        b = b_local.to(stream) if stream is not None else b_local
        return solver_fn(dist_op.vmult, b, control, diag=diag_local, dot_weight=dist_op.dot_weight,
                         comm=dist_op.comm, **kwargs)

    return run


def solve_cg_merged_dist(dist_op, b_local, control: SolverControl, diag_local=None, **kwargs):
    """Merged CG on the rank's block ``b_local``; returns ``(x_local, info)``."""
    return make_dist_solver(solve_cg_merged, dist_op, control, **kwargs)(b_local, diag_local)


def solve_cg_dist(dist_op, b_local, control: SolverControl, diag_local=None, **kwargs):
    """Plain CG on the rank's block ``b_local``; returns ``(x_local, info)``."""
    return make_dist_solver(solve_cg, dist_op, control, **kwargs)(b_local, diag_local)
