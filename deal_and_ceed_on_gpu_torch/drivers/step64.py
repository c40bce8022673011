"""step-64 Helmholtz driver: the reference's correctness workload.

Counterpart of ``deal_and_ceed_on_gpu_tpu/drivers/step64.py`` and of the
reference's ``HelmholtzProblem`` (``step-64/step-64.cu:55-633``): solve
``-laplace(u) + a(x) u = 1`` with ``a(x) = 10/(0.05 + 2|x|^2)``, Q3 elements
with the Gauss rule q = 4 on a globally refined unit cube, zero Dirichlet
boundary, CG to ``1e-12 * |b|`` (``step-64/step-64.cu:513-514``), then report
the iteration count and the solution's L2 norm, with the plain and the
merged CG solver in turn (``step-64/step-64.cu:682-688``).

The default backend is ``qgrid``: K3 on the card, its plain torch version on
the CPU. ``general`` is K4 (the element-major cell apply between the torch
gather and scatter). ``structured`` is the plain torch cell loop, the
comparator.
``--precond``: ``none`` (the reference's identity), ``jacobi`` (the true
diagonal), ``fdm`` (the Poisson fast-diagonalization solve,
``solvers/fdm.py``) or ``mg`` (the geometric multigrid V-cycle,
``solvers/multigrid.py``, every level a ``HelmholtzOperator`` on the
driver's backend: K3 on every level with ``qgrid``); ``fdm`` and ``mg`` run
plain CG only (merged CG takes a diagonal), as in the JAX driver.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain versions. Not ported yet: the ``.vtr`` output (slice H).

Run: ``python -m deal_and_ceed_on_gpu_torch.drivers.step64 --refine 4``.
"""

from __future__ import annotations

import argparse

import torch

from ..fe_space import FESpace
from ..mesh import BrickMesh
from ..models import HelmholtzOperator, assemble_rhs, l2_norm_function
from ..solvers import ReductionControl, solve_cg, solve_cg_merged
from ..utils.logging import rank0_print as pcout
from ..utils.timer import Timer
from .bp5 import DTYPES, resolve_device

__all__ = ["run", "main"]

BACKENDS = ("qgrid", "general", "structured")
PRECONDITIONERS = ("none", "jacobi", "fdm", "mg")


def run(
    n_refine: int = 3,
    degree: int = 3,
    dtype: str = "float64",
    backend: str = "qgrid",
    use_merged: bool = False,
    rtol: float = 1e-12,
    max_steps: int = 2000,
    precond: str = "none",
    device: str = "cuda",
):
    """One solve. Returns ``n_iterations``, ``l2_norm``, the solution ``x``,
    the ``space``, ``seconds``, the solve's wall time (fenced with
    ``torch.cuda.synchronize`` on the card), and ``setup_s``, the
    preconditioner's set-up seconds (host ``eigh`` for fdm; levels, coarse
    assembly and inverse, smoother for mg)."""
    if precond not in PRECONDITIONERS:
        raise ValueError(f"precond {precond!r}: expected one of {PRECONDITIONERS}")
    if use_merged and precond in ("fdm", "mg"):
        raise ValueError(f"{precond} preconditioning requires the plain solver")
    dev = resolve_device(device)
    mesh = BrickMesh.hyper_cube().refine_global(n_refine)
    space = FESpace.create(mesh, degree, rule="gauss", dtype=DTYPES[dtype], device=dev)
    op = HelmholtzOperator(space, backend=backend)
    pcout(f"   Number of active cells: {mesh.n_cells}")
    pcout(f"   Number of degrees of freedom: {space.n_dofs}")

    b = assemble_rhs(space, 1.0, backend=backend)
    # reference criterion 1e-12 * |b| (step-64/step-64.cu:513-514): with
    # x0 = 0 the initial residual is b, so this is reduction = rtol.
    # "none" is the reference's DiagonalMatrix filled with 1.0 (the
    # solvers' diag=None), "jacobi" the operator's true diagonal
    control = ReductionControl(max_steps, tolerance=0.0, reduction=rtol)
    t_setup = Timer().start()
    setup_s = {}
    diag = None
    if precond == "jacobi":
        diag = op.jacobi_preconditioner()
    elif precond == "fdm":
        from ..solvers import FDMSolver

        fdm = FDMSolver(space)
        diag = fdm.apply
        setup_s = dict(fdm.setup_s)
    elif precond == "mg":
        from ..solvers import Multigrid

        mg = Multigrid(space, make_op=lambda s: HelmholtzOperator(s, backend=backend), fine_op=op)
        diag = mg.vcycle
        setup_s = dict(mg.setup_s)
    t_setup.stop(fence=b)
    setup_s["total"] = t_setup.elapsed
    solver = solve_cg_merged if use_merged else solve_cg
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timer = Timer().start()
    x, info = solver(op.vmult, b, control, diag=diag)
    timer.stop(fence=x)
    control.check(info)
    it = int(info["n_iterations"])
    pcout(f"  Solved in {it} iterations.")
    norm = float(l2_norm_function(space, x))
    pcout(f"  solution norm: {norm:.12g}")
    return {"n_iterations": it, "l2_norm": norm, "x": x, "space": space, "seconds": timer.elapsed,
            "setup_s": setup_s}


def main(argv=None):
    ap = argparse.ArgumentParser(description="step-64 Helmholtz (PyTorch + CUDA)")
    ap.add_argument("--refine", type=int, default=3)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    ap.add_argument(
        "--backend", default="qgrid", choices=BACKENDS,
        help="qgrid: the K3 CUDA kernel; general: the K4 CUDA kernel; structured: the plain torch cell loop",
    )
    ap.add_argument(
        "--precond", default="none", choices=PRECONDITIONERS,
        help="none = the reference's DiagonalMatrix(1.0); jacobi = the true diagonal; "
        "fdm / mg = fast diagonalization / multigrid (plain CG only)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    for use_merged in (False, True):
        if use_merged and args.precond in ("fdm", "mg"):
            continue  # merged CG takes a diagonal preconditioner only
        pcout(f"--- use_merged = {use_merged} ---")
        run(
            n_refine=args.refine, degree=args.degree, dtype=args.dtype, backend=args.backend,
            use_merged=use_merged, precond=args.precond, device=args.device,
        )


if __name__ == "__main__":
    main()
