"""Time to a 1e-10 solve on the sine-mapped mesh: f64 merged CG with Jacobi.

Counterpart of the mapped case of the JAX package's
``scripts/bench_solvers_r3.py`` (``RESULTS.md`` "time to 1e-10"): Poisson on
``sine_map(0.05)`` over ``BrickMesh((m, m, m))`` (m = 32: 912,673 DoFs),
p = 3, GLL (q = 4), f64, zero Dirichlet, right-hand side 1, solved by
``solve_cg_merged`` with ``op.jacobi_preconditioner()`` and
``ReductionControl(2000, 0, 1e-10)``, the reference-style Jacobi path. The
operator and right-hand side set-up, the diagonal, and two solves (the first
pays the kernel build and the first-touch costs) are timed apart, fenced
with ``torch.cuda.synchronize``; then the iteration count, the true relative
residual ``|b - A x| / |b|`` and the solution's L2 norm.

The JAX script also runs multigrid, iterative refinement and FDM; the port
has none of them yet (ROADMAP slice E) and prints one skip line for them.
Run: ``python -m deal_and_ceed_on_gpu_torch.scripts.bench_solvers_r3
[--elements 32] [--backend general|structured|qgrid] [--rule gauss_lobatto]
[--device cpu]`` (``qgrid`` needs ``--rule gauss``).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..drivers.bp5 import resolve_device
from ..fe_space import FESpace
from ..mesh import BrickMesh, sine_map
from ..models import PoissonOperator, assemble_rhs, l2_norm_function
from ..solvers import ReductionControl, solve_cg_merged
from ..utils.logging import rank0_print as pcout

__all__ = ["run_case"]

SKIPPED = "MG-CG, IR, IR+MG, FDM"
DEGREE = 3


def run_case(n_elements: int = 32, backend: str = "general", rule: str = "gauss_lobatto", device="cuda") -> dict:
    """One mapped Jacobi solve; returns its iterations, true relative
    residual, L2 norm, the solution, the space and the timed steps (s)."""
    dev = resolve_device(str(device))

    def timed(label, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        pcout(f"  {label}: {dt:.4f} s")
        return out, dt

    mesh = BrickMesh((n_elements,) * 3).deform(*sine_map(0.05))
    pcout(f"== sine-mapped {n_elements}^3 p={DEGREE} {rule}, {backend} ==")
    space = FESpace.create(mesh, DEGREE, n_q=DEGREE + 1, rule=rule, dtype=torch.float64, device=dev)
    pcout(f"  {space.n_dofs} DoFs f64")
    (op, b), t_setup = timed("operator + rhs setup",
                             lambda: (PoissonOperator(space, backend=backend), assemble_rhs(space, 1.0)))
    diag, t_diag = timed("jacobi diagonal", op.jacobi_preconditioner)
    control = ReductionControl(2000, tolerance=0.0, reduction=1e-10)
    solves = []
    for k in (1, 2):
        (x, info), t = timed(f"jacobi CG #{k}", lambda: solve_cg_merged(op.vmult, b, control, diag=diag))
        control.check(info)
        solves.append(t)
    res = float(torch.linalg.vector_norm(b - op.vmult(x)) / torch.linalg.vector_norm(b))
    it = int(info["n_iterations"])
    l2 = float(l2_norm_function(space, x))
    pcout(f"  jacobi CG: {it} its, true rel res {res:.3e}, L2 norm {l2:.17g}")
    pcout(f"  {SKIPPED}: not ported yet (ROADMAP slice E)")
    return {"n_iterations": it, "true_rel_res": res, "l2_norm": l2, "x": x, "space": space,
            "setup_s": t_setup, "diag_s": t_diag, "solve_s": solves}


def main(argv=None):
    ap = argparse.ArgumentParser(description="time to 1e-10 on the sine-mapped mesh (PyTorch + CUDA)")
    ap.add_argument("--elements", type=int, default=32)
    ap.add_argument("--backend", default="general", choices=["general", "structured", "qgrid"])
    ap.add_argument("--rule", default="gauss_lobatto", choices=["gauss_lobatto", "gauss"])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run_case(args.elements, args.backend, args.rule, device=args.device)


if __name__ == "__main__":
    main()
