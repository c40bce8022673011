"""Time to a 1e-10 solve: the uniform ~1M-DoF cube and the sine-mapped mesh,
every solver path.

Counterpart of the JAX package's ``scripts/bench_solvers_r3.py``
(``RESULTS.md`` "time to 1e-10"), two cases:

- ``uniform``: ``BrickMesh.bp5_cycle(26)`` (32×16×16 elements), p = 5, GLL,
  1,056,321 DoFs; default backend ``stencil`` (K1);
- ``mapped``: ``sine_map(0.05)`` on ``BrickMesh((m, m, m))`` (m = 32:
  912,673 DoFs), p = 3, GLL (q = 4); default backend ``general`` (K4).

Poisson, f64, zero Dirichlet, right-hand side 1, to a relative residual of
1e-10, by five rows:

- ``jacobi``: ``solve_cg_merged`` with ``op.jacobi_preconditioner()`` and
  ``ReductionControl(2000, 0, 1e-10)``;
- ``mg``: plain CG with the multigrid V-cycle (``solvers/multigrid.py``);
- ``ir``: mixed-precision iterative refinement, f32 Jacobi merged CG inside
  (``solvers/ir.py``);
- ``ir-mg``: the same with the f32 V-cycle inside (``inner_max=40``);
- ``fdm``: the fast-diagonalization direct solve (uniform case only).

Every level of both multigrids is a ``PoissonOperator`` on the case's
backend, so on the card each smoother apply and residual runs the kernel;
with ``separable`` (uniform) or ``structured`` (mapped) the rows are those
of the JAX script. Each row is solved twice (the first pays the kernel
build and first-touch costs) and prints its iterations, true relative
residual ``|b - A x| / |b|``, solution L2 norm, the warm (second) solve's
wall time fenced with ``torch.cuda.synchronize``, its set-up seconds apart
from the solve, and the launches of each kernel in the row's two solves.

Run: ``python -m deal_and_ceed_on_gpu_torch.scripts.bench_solvers_r3
[--case uniform|mapped|both] [--cycle 26] [--elements 32] [--backend ...]
[--rule gauss_lobatto] [--rows jacobi,mg,ir,ir-mg,fdm] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..drivers.bp5 import resolve_device
from ..fe_space import FESpace
from ..mesh import BrickMesh, sine_map
from ..models import PoissonOperator, assemble_rhs, l2_norm_function
from ..ops import banded, general, qgrid, stencil
from ..solvers import FDMSolver, Multigrid, ReductionControl, solve_cg, solve_cg_ir, solve_cg_merged
from ..utils.logging import rank0_print as pcout

__all__ = ["run_case", "run_uniform", "run_rows", "ROWS"]

ROWS = ("jacobi", "mg", "ir", "ir-mg", "fdm")
DEGREE = 3  # the mapped case
UNIFORM_DEGREE = 5
KERNELS = {"K1": stencil, "K2": banded, "K3": qgrid, "K4": general}


def _launches():
    return {k: m.LAUNCHES for k, m in KERNELS.items()}


def run_rows(title, mesh, degree, rule, backend, device, rows) -> dict:
    """The rows ``rows`` on one mesh. Returns ``space`` and ``rows`` (per row:
    ``n_iterations`` (``(n_outer, n_inner)`` for the IR rows),
    ``true_rel_res``, ``l2_norm``, ``solve_s`` (the two solves), ``setup_s``,
    ``launches`` per kernel and, for the multigrid rows, ``level_backends``),
    and, when the Jacobi row ran, its values at
    the top level with the solution ``x``, ``setup_s`` (operator and
    right-hand side) and ``diag_s``."""
    dev = resolve_device(str(device))

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(label, fn):
        fence()
        t0 = time.perf_counter()
        out = fn()
        fence()
        dt = time.perf_counter() - t0
        pcout(f"  {label}: {dt:.4f} s")
        return out, dt

    pcout(f"== {title}, {backend} ==")
    space = FESpace.create(mesh, degree, n_q=degree + 1, rule=rule, dtype=torch.float64, device=dev)
    pcout(f"  {space.n_dofs} DoFs f64")
    (op, b), t_setup = timed("operator + rhs setup",
                             lambda: (PoissonOperator(space, backend=backend), assemble_rhs(space, 1.0)))
    control = ReductionControl(2000, tolerance=0.0, reduction=1e-10)
    make_op = lambda s: PoissonOperator(s, backend=backend)  # noqa: E731
    out = {"space": space, "rows": {}}
    state = {}

    def rel_res(x):
        return float(torch.linalg.vector_norm(b - op.vmult(x)) / torch.linalg.vector_norm(b))

    def sp32():
        if "sp32" not in state:
            state["sp32"] = FESpace.create(mesh, degree, n_q=degree + 1, rule=rule, dtype=torch.float32, device=dev)
            state["op32"], state["t32"] = timed("f32 operator setup", lambda: make_op(state["sp32"]))
        return state["sp32"], state["op32"]

    for row in rows:
        setup = {}
        if row == "jacobi":
            diag, setup["diagonal"] = timed("jacobi diagonal", op.jacobi_preconditioner)
            solve = lambda: solve_cg_merged(op.vmult, b, control, diag=diag)  # noqa: E731
        elif row == "mg":
            mg, setup["total"] = timed("MG setup", lambda: Multigrid(space, make_op=make_op, fine_op=op))
            setup.update(mg.setup_s)
            solve = lambda: solve_cg(op.vmult, b, control, diag=mg.vcycle)  # noqa: E731
        elif row == "ir":
            s32, op32 = sp32()
            setup["f32 operator"] = state["t32"]
            d32, setup["f32 diagonal"] = timed("f32 jacobi diagonal", op32.jacobi_preconditioner)
            solve = lambda: solve_cg_ir(op32, op, b, diag32=d32)  # noqa: E731
        elif row == "ir-mg":
            s32, op32 = sp32()
            mg32, setup["total"] = timed("f32 MG setup", lambda: Multigrid(s32, make_op=make_op, fine_op=op32))
            setup.update(mg32.setup_s)
            solve = lambda: solve_cg_ir(op32, op, b, diag32=mg32.vcycle, inner_max=40)  # noqa: E731
        elif row == "fdm":
            fdm, setup["total"] = timed("FDM setup", lambda: FDMSolver(space))
            setup.update(fdm.setup_s)
            solve = lambda: (fdm.solve(b), {"n_iterations": 1})  # noqa: E731
        else:
            raise ValueError(f"unknown row {row!r}: expected one of {ROWS}")
        before = _launches()
        times = []
        for k in (1, 2):
            (x, info), t = timed(f"{row} #{k}", solve)
            if row in ("jacobi", "mg"):
                control.check(info)
            times.append(t)
        its = (info["n_outer"], info["n_inner"]) if row.startswith("ir") else int(info["n_iterations"])
        res = rel_res(x)  # on the f64 operator: fdm's launches are this check's
        launches = {k: v - before[k] for k, v in _launches().items() if v > before[k]}
        l2 = float(l2_norm_function(space, x))
        out["rows"][row] = {"n_iterations": its, "true_rel_res": res, "l2_norm": l2, "solve_s": times,
                            "setup_s": setup, "launches": launches}
        if row in ("mg", "ir-mg"):
            out["rows"][row]["level_backends"] = [o.backend for o in (mg if row == "mg" else mg32).ops]
        its_s = f"{its[0]} outer / {its[1]} inner" if row.startswith("ir") else f"{its} its"
        pcout(f"  {row}: {its_s}, true rel res {res:.3e}, L2 norm {l2:.17g}, warm solve {times[1]:.4f} s, "
              "set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in setup.items())
              + ", launches " + (", ".join(f"{k} {v}" for k, v in launches.items()) or "none"))
        if row == "jacobi":
            out.update({"n_iterations": its, "true_rel_res": res, "l2_norm": l2, "x": x, "setup_s": t_setup,
                        "diag_s": setup["diagonal"], "solve_s": times})
    return out


def run_case(n_elements: int = 32, backend: str = "general", rule: str = "gauss_lobatto", device="cuda",
             rows=("jacobi",)) -> dict:
    """The mapped case (``sine_map(0.05)`` on ``n_elements``³, p = 3); see
    :func:`run_rows` for what it returns."""
    mesh = BrickMesh((n_elements,) * 3).deform(*sine_map(0.05))
    return run_rows(f"sine-mapped {n_elements}^3 p={DEGREE} {rule}", mesh, DEGREE, rule, backend, device, rows)


def run_uniform(cycle: int = 26, backend: str = "stencil", device="cuda", rows=ROWS) -> dict:
    """The uniform case (``BrickMesh.bp5_cycle(cycle)``, p = 5, GLL)."""
    mesh = BrickMesh.bp5_cycle(cycle)
    return run_rows(f"uniform cycle {cycle} p={UNIFORM_DEGREE}", mesh, UNIFORM_DEGREE, "gauss_lobatto", backend,
                    device, rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description="time to 1e-10, uniform cube and sine-mapped mesh (PyTorch + CUDA)")
    ap.add_argument("--case", default="both", choices=["uniform", "mapped", "both"])
    ap.add_argument("--cycle", type=int, default=26, help="the uniform case's BP5 cycle")
    ap.add_argument("--elements", type=int, default=32, help="the mapped case's elements per axis")
    ap.add_argument("--backend", default=None,
                    help="default: stencil (uniform), general (mapped); separable / structured are the JAX rows")
    ap.add_argument("--rule", default="gauss_lobatto", choices=["gauss_lobatto", "gauss"],
                    help="the mapped case's rule (qgrid needs gauss)")
    ap.add_argument("--rows", default=",".join(ROWS), help=f"comma list of {', '.join(ROWS)} (fdm: uniform only)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    rows = tuple(args.rows.split(","))
    out = {}
    if args.case in ("uniform", "both"):
        out["uniform"] = run_uniform(args.cycle, args.backend or "stencil", args.device, rows)
    if args.case in ("mapped", "both"):
        out["mapped"] = run_case(args.elements, args.backend or "general", args.rule, args.device,
                                 tuple(r for r in rows if r != "fdm"))
    return out


if __name__ == "__main__":
    main()
