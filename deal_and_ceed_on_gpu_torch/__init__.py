"""deal_and_ceed_on_gpu_torch — the PyTorch + CUDA port of deal_and_ceed_on_gpu_tpu.

A matrix-free high-order FEM framework (the CEED bake-off problems BP1-BP6
and the step-64 Helmholtz problem on uniform, graded and mapped bricks so
far) for NVIDIA Hopper: plain PyTorch for the tensor code, hand-written CUDA
kernels for the hot operator apply (``csrc/``, built with ``nvcc`` at first
use). Module names mirror the JAX package, which stays the reference. The
port never imports jax; the host-side numpy modules are its own copies.

Layer map:
  L0  mesh/dof/geometry     -> mesh.py, basis.py, geometry.py, fe_space.py
  L2  matrix-free kernels   -> ops/ (sum_factorization, local_global,
                               separable, stencil + csrc/stencil.cu (K1),
                               banded + csrc/banded.cu (K2),
                               qgrid + csrc/qgrid.cu (K3), general +
                               csrc/general.cu (K4), cg + csrc/cg.cu
                               (K5, the fused CG iteration), copy +
                               csrc/copy.cu (K6, the bandwidth probe))
  L3  operators + solvers   -> models/ (poisson, helmholtz, mass, vector,
                               bp), solvers/
  L4  drivers               -> drivers/bp5.py, drivers/bp.py, drivers/step64.py,
                               scripts/exp_solver_budget.py, scripts/bench_general.py,
                               scripts/bench_solvers_r3.py

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .basis import Basis1D, gauss_lobatto_points, gauss_points
from .fe_space import FESpace
from .geometry import Geometry
from .mesh import BrickMesh, MappedMesh, shear_map, sine_map
from .models.helmholtz import HelmholtzOperator
from .models.mass import MassOperator
from .models.poisson import PoissonOperator
from .solvers import (
    IterationNumberControl,
    NoConvergence,
    ReductionControl,
    SolverControl,
    solve_cg,
    solve_cg_fused,
    solve_cg_merged,
)

__all__ = [
    "Basis1D",
    "BrickMesh",
    "MappedMesh",
    "Geometry",
    "FESpace",
    "HelmholtzOperator",
    "MassOperator",
    "PoissonOperator",
    "SolverControl",
    "IterationNumberControl",
    "ReductionControl",
    "NoConvergence",
    "solve_cg",
    "solve_cg_fused",
    "solve_cg_merged",
    "gauss_lobatto_points",
    "gauss_points",
    "shear_map",
    "sine_map",
]
