"""deal_and_ceed_on_gpu_torch — the PyTorch + CUDA port of deal_and_ceed_on_gpu_tpu.

A matrix-free high-order FEM framework (the CEED bake-off problems BP1-BP6
and the step-64 Helmholtz problem on uniform, graded and mapped bricks, and,
since slice F, Poisson / Helmholtz on adaptive hanging-node meshes with
adaptive multigrid and the AMR loop) for NVIDIA Hopper: plain PyTorch for the tensor code, hand-written CUDA
kernels for the hot operator apply (``csrc/``, built with ``nvcc`` at first
use). Module names mirror the JAX package, which stays the reference. The
port never imports jax; the host-side numpy modules are its own copies.

Layer map:
  L0  mesh/dof/geometry     -> mesh.py, basis.py, geometry.py, fe_space.py,
                               adaptive.py (AdaptiveMesh, AdaptiveSpace:
                               the 2:1 octree and the hanging-node
                               constraints)
  L2  matrix-free kernels   -> ops/ (sum_factorization, local_global
                               (structured and indexed transfers),
                               separable, stencil + csrc/stencil.cu (K1),
                               banded + csrc/banded.cu (K2),
                               qgrid + csrc/qgrid.cu (K3), general +
                               csrc/general.cu (K4), cg + csrc/cg.cu
                               (K5, the fused CG iteration), copy +
                               csrc/copy.cu (K6, the bandwidth probe))
  L3  operators + solvers   -> models/ (poisson, helmholtz, mass, vector,
                               bp; assemble_dense), adaptive.py (the
                               adaptive operators on K4, the estimator, the
                               marking, amr_loop), fe_evaluation.py,
                               solvers/ (cg, cg_merged, cg_fused, fdm, ir,
                               multigrid, adaptive_mg)
  L4  drivers               -> drivers/bp5.py, drivers/bp.py, drivers/step64.py,
                               drivers/amr.py, scripts/exp_solver_budget.py,
                               scripts/bench_general.py,
                               scripts/bench_solvers_r3.py, scripts/bench_adaptive.py

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .basis import Basis1D, gauss_lobatto_points, gauss_points
from .fe_space import FESpace
from .geometry import Geometry
from .mesh import BrickMesh, MappedMesh, shear_map, sine_map
from .models.helmholtz import HelmholtzOperator
from .models.mass import MassOperator
from .models.operator_base import assemble_dense
from .models.poisson import PoissonOperator
from .solvers import (
    AdaptiveMultigrid,
    FDMSolver,
    IterationNumberControl,
    Multigrid,
    NoConvergence,
    ReductionControl,
    SolverControl,
    solve_cg,
    solve_cg_fused,
    solve_cg_ir,
    solve_cg_merged,
)

# after .solvers: adaptive.py imports ops/, whose cg.py imports solvers/, whose
# adaptive_mg.py imports adaptive.py (a cycle when adaptive.py comes first)
from .adaptive import (
    AdaptiveHelmholtzOperator,
    AdaptiveMesh,
    AdaptivePoissonOperator,
    AdaptiveSpace,
    amr_loop,
    assemble_rhs_adaptive,
    estimate_gradient_recovery,
    evaluate_at_points,
    mark_doerfler,
)

__all__ = [
    "AdaptiveHelmholtzOperator",
    "AdaptiveMesh",
    "AdaptiveMultigrid",
    "AdaptivePoissonOperator",
    "AdaptiveSpace",
    "amr_loop",
    "assemble_rhs_adaptive",
    "estimate_gradient_recovery",
    "evaluate_at_points",
    "mark_doerfler",
    "Basis1D",
    "BrickMesh",
    "MappedMesh",
    "Geometry",
    "FESpace",
    "FDMSolver",
    "HelmholtzOperator",
    "MassOperator",
    "PoissonOperator",
    "Multigrid",
    "SolverControl",
    "IterationNumberControl",
    "ReductionControl",
    "NoConvergence",
    "solve_cg",
    "solve_cg_fused",
    "solve_cg_merged",
    "solve_cg_ir",
    "assemble_dense",
    "gauss_lobatto_points",
    "gauss_points",
    "shear_map",
    "sine_map",
]
