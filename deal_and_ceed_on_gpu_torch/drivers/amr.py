"""AMR driver: the solve -> estimate -> mark -> refine loop.

Counterpart of ``deal_and_ceed_on_gpu_tpu/drivers/amr.py``: a deal.II
step-6-style workflow on the adaptive (hanging-node) machinery. Poisson
with a sharp localized source, Zienkiewicz-Zhu gradient-recovery
indicators, Doerfler marking, 2:1-balanced refinement; prints the same
history table (cells, DoFs, CG iterations, global estimate). Every solve
applies the operator through K4 on the card (``AdaptivePoissonOperator``
on ``auto``) and, with ``--precond mg|mg-ir``, every multigrid level too.

``--write-solution PATH.vtu`` writes the last step's solution as a VTK
unstructured grid (``utils/vtk.write_solution_vtu``). ``--device`` defaults
to ``cuda`` and raises when no card is present; ``--device cpu`` runs the
plain torch versions (the test path).

Run: ``python -m deal_and_ceed_on_gpu_torch.drivers.amr --base 4 --steps 3
--precond mg``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..adaptive import amr_loop
from ..mesh import BrickMesh
from ..utils.logging import rank0_print as pcout
from .bp5 import resolve_device

__all__ = ["gaussian_source", "run", "main"]


def gaussian_source(center=(0.8, 0.8, 0.8), width=0.01):
    """The loop's right-hand side ``f(x) = exp(-|x - center|^2 / width)``."""
    c = np.asarray(center, dtype=np.float64)

    def f(x):
        return np.exp(-((x - c) ** 2).sum(axis=-1) / width)

    return f


def run(base=4, degree=2, steps=3, theta=0.5, center=(0.8, 0.8, 0.8), width=0.01, precond="none",
        dtype="float64", reduction=None, device="cuda", write_solution=None):
    """The loop of :func:`main`; prints the history table, writes the last
    step's solution to ``write_solution`` (a ``.vtu``) if given, and
    returns the history (``adaptive.amr_loop``'s dicts)."""
    dev = resolve_device(device)
    pcout(f"AMR: Q{degree}, base {base}^3, source at {tuple(float(v) for v in center)}")
    hist = amr_loop(
        BrickMesh((base,) * 3),
        degree,
        f=gaussian_source(center, width),
        n_steps=steps,
        theta=theta,
        precond=precond,
        dtype=getattr(torch, dtype),
        reduction=reduction or (1e-10 if dtype == "float64" else 1e-5),
        device=dev,
    )
    pcout(f"{'step':>4} {'cells':>8} {'DoFs':>9} {'CG its':>7} {'estimate':>12}")
    for k, h in enumerate(hist):
        pcout(
            f"{k:>4} {h['n_cells']:>8} {h['n_dofs']:>9} "
            f"{h['n_iterations']:>7} {h['eta']:>12.4e}"
        )
    if write_solution:
        from ..utils.vtk import write_solution_vtu

        write_solution_vtu(write_solution, hist[-1]["space"], hist[-1]["x"])
        pcout(f"solution written to {write_solution}")
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser(description="adaptive refinement demo (PyTorch + CUDA)")
    ap.add_argument("--base", type=int, default=4, help="base mesh cells/axis")
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--theta", type=float, default=0.5, help="Doerfler fraction")
    ap.add_argument("--center", type=float, nargs=3, default=(0.8, 0.8, 0.8))
    ap.add_argument("--width", type=float, default=0.01, help="source width^2")
    ap.add_argument(
        "--precond",
        choices=("none", "mg", "mg-ir"),
        default="none",
        help="mg = global-coarsening adaptive multigrid preconditioner; "
        "mg-ir = mixed-precision iterative refinement (f32 MG inner CG, "
        "f64 true residuals)",
    )
    ap.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    ap.add_argument(
        "--reduction",
        type=float,
        default=None,
        help="relative residual target per solve (default 1e-10 for "
        "float64; 1e-5 for float32, where 1e-10 is unattainable)",
    )
    ap.add_argument(
        "--write-solution",
        metavar="PATH.vtu",
        default=None,
        help="write the final step's solution as a VTK unstructured grid",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(
        base=args.base, degree=args.degree, steps=args.steps, theta=args.theta, center=args.center,
        width=args.width, precond=args.precond, dtype=args.dtype, reduction=args.reduction, device=args.device,
        write_solution=args.write_solution,
    )


if __name__ == "__main__":
    main()
