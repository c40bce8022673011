"""Solver iteration control.

Copy of ``deal_and_ceed_on_gpu_tpu/solvers/control.py``: deal.II
``SolverControl`` / ``IterationNumberControl`` as used by the drivers
(``bp5/step-64.cu:443-445`` fixes 200 iterations with tolerance
``1e-6 * |b|``; ``step-64/step-64.cu:513-514`` solves to ``1e-12 * |b|``).
The control object exposes a pure predicate on host numbers (the solvers
read the residual norm once per iteration); the ``NoConvergence`` exception
is raised by :func:`check` after the solve returns (reference
``bp5/solver.h:539-540``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.profiling import count

__all__ = [
    "SolverControl",
    "IterationNumberControl",
    "ReductionControl",
    "NoConvergence",
]


class NoConvergence(RuntimeError):
    def __init__(self, last_step, last_residual):
        super().__init__(
            f"solver did not converge: step {last_step}, residual {last_residual}"
        )
        self.last_step = last_step
        self.last_residual = last_residual


@dataclasses.dataclass(frozen=True)
class SolverControl:
    """Iterate while ``res > tolerance`` and ``it < max_steps``; reaching
    ``max_steps`` without meeting the tolerance is a failure."""

    max_steps: int
    tolerance: float = 1e-10

    success_on_max_steps: bool = False

    def effective_tolerance(self, res0=None):
        """The stop threshold; subclasses may make it ``res0``-relative."""
        return self.tolerance

    def continue_pred(self, it, res, res0=None):
        return it < self.max_steps and res > self.effective_tolerance(res0)

    def check(self, info: dict) -> dict:
        """Host-side convergence verdict; raises NoConvergence on failure.
        Each read of a tensor counts one ``host_syncs``."""
        count("host_syncs", sum(isinstance(info.get(k), torch.Tensor) for k in ("n_iterations", "res_norm", "res0")))
        it = int(info["n_iterations"])
        res = float(info["res_norm"])
        res0 = float(info["res0"]) if "res0" in info else None
        tol = float(self.effective_tolerance(res0))
        ok = res <= tol or (self.success_on_max_steps and it >= self.max_steps)
        if not ok:
            raise NoConvergence(it, res)
        return info


@dataclasses.dataclass(frozen=True)
class IterationNumberControl(SolverControl):
    """Always run ``max_steps`` iterations (unless tolerance met); reaching
    max_steps counts as success — the BP5 benchmark mode."""

    success_on_max_steps: bool = True


@dataclasses.dataclass(frozen=True)
class ReductionControl(SolverControl):
    """Succeed when the residual drops by ``reduction`` relative to the
    initial residual, or below the absolute tolerance (deal.II
    ``ReductionControl``; the step-64 driver's ``1e-12 * |b|`` criterion,
    ``step-64/step-64.cu:513-514``, is ``reduction=1e-12`` with ``x0=0``)."""

    reduction: float = 1e-6

    def effective_tolerance(self, res0=None):
        if res0 is None:
            return self.tolerance
        return max(self.tolerance, self.reduction * res0)
