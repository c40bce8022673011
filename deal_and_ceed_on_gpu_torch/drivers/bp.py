"""CEED bake-off sweep driver: any of BP1..BP6 over polynomial degrees.

Counterpart of ``deal_and_ceed_on_gpu_tpu/drivers/bp.py``: the
BASELINE.json breadth configurations ("BP5 GLL q=p+1 sweep p=1..8",
"BP1/BP3 q=p+2", "vector BP4/BP6") with the reference's throughput metric
and line format (``<mode> <dofs/rank> <max_throughput>``,
``bp5/step-64.cu:470-474``):

    pcg-merged <dofs> <DoF/s>
    vmult      <dofs> <DoF/s>

Vector rows count all components. Throughput = rows * iterations / wall
time, max over repetitions; timing fences with ``torch.cuda.synchronize``.
The vmult chain folds ``1 / max(|A u|, 1)`` into the operator tables
(``fold_scale``), as the JAX driver does, so every step is one pure apply.

The default backend is the port's kernel of each BP (``models/bp.py``): K2
(``banded``) for BP1-BP4, K1 (``stencil``) for BP5/BP6 on a uniform brick;
``--backend general`` runs any BP on K4 (the JAX driver names
``pallas_general`` for the Gauss-rule BPs).
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain torch versions of the kernels (the test path).

Run: ``python -m deal_and_ceed_on_gpu_torch.drivers.bp --bp bp3 --p-min 5
--p-max 5 --target-dofs 4000000 --dtype float64``.
"""

from __future__ import annotations

import argparse

import torch

from ..mesh import BrickMesh
from ..models import assemble_rhs, l2_norm_function, make_bp_operator
from ..solvers import IterationNumberControl, solve_cg_merged
from ..utils.logging import rank0_print as pcout
from ..utils.timer import Timer
from .bp5 import DTYPES, resolve_device

__all__ = ["MODES", "main", "run_sweep", "target_mesh"]

MODES = ("pcg-merged", "vmult")


def target_mesh(p: int, target_dofs: int) -> BrickMesh:
    """Cube mesh with ~target_dofs at degree p (the JAX driver's rule)."""
    m = max(2, round(target_dofs ** (1 / 3) / p))
    return BrickMesh((m, m, m))


def run_sweep(
    bp: str = "bp5",
    degrees=range(1, 9),
    target_dofs: int = 2_000_000,
    n_iterations: int = 100,
    n_repetitions: int = 3,
    dtype: str = "float32",
    modes=MODES,
    backend: str | None = None,
    stream_dtype: str | None = None,
    device: str = "cuda",
):
    """Returns ``{p: res}`` with the per-mode throughputs, ``n_iterations``
    and ``finite`` (per mode), ``l2_norm`` (component 0 of the pcg-merged
    solution) and ``backend``. ``stream_dtype="bfloat16"`` stores the
    vectors at bf16, the apply and the dots accumulate at ``dtype``."""
    unknown = set(modes) - set(MODES)
    if unknown:
        raise ValueError(f"unknown modes {sorted(unknown)}")
    dev = resolve_device(device)
    cd = DTYPES[dtype]
    sd = cd if stream_dtype is None else DTYPES[stream_dtype]
    dot_dtype = cd if sd != cd else None
    results = {}
    for p in degrees:
        mesh = target_mesh(p, target_dofs)
        space, op = make_bp_operator(bp, mesh, p, dtype=cd, backend=backend, stream_dtype=sd, device=dev)
        n = space.n_dofs
        n_comp = getattr(op, "n_components", 1)
        pcout(f"{bp} p={p}: {mesh.n_cells} cells, {n} DoFs x {n_comp} comp ({op.backend})")
        res = {"n_iterations": {}, "finite": {}, "backend": op.backend}

        b1 = assemble_rhs(space, 1.0)
        b = b1 if n_comp == 1 else b1.expand(n_comp, n).contiguous()
        control = IterationNumberControl(n_iterations, 1e-6 * float(torch.linalg.vector_norm(b)))
        b_solve = b.to(sd)
        vm = op.vmult

        if "pcg-merged" in modes:
            x, info = solve_cg_merged(vm, b_solve, control, dot_dtype=dot_dtype)
            times, iters = [], []
            for _ in range(n_repetitions):
                t = Timer().start()
                x, info = solve_cg_merged(vm, b_solve, control, dot_dtype=dot_dtype)
                t.stop(fence=x)
                times.append(t.elapsed)
                iters.append(int(info["n_iterations"]))
            tp = max(n * n_comp * i / t for t, i in zip(times, iters))
            pcout(f"pcg-merged {n * n_comp} {tp:.6g}")
            res["pcg-merged"] = tp
            res["n_iterations"]["pcg-merged"] = iters[-1]
            res["finite"]["pcg-merged"] = bool(torch.isfinite(x).all())
            x0 = x if n_comp == 1 else x[0]
            res["l2_norm"] = float(l2_norm_function(space, x0.to(cd)))

        if "vmult" in modes:
            bc = b_solve.to(cd)
            u = (bc / torch.linalg.vector_norm(bc)).to(sd)
            v = vm(u).to(cd)
            # fold the normalization into the tables: pure chained applies
            op.fold_scale(1.0 / max(float(torch.linalg.vector_norm(v)), 1.0))

            def chain(u):
                for _ in range(n_iterations):
                    u = vm(u)
                return u

            out = chain(u)
            best = 0.0
            for _ in range(n_repetitions):
                t = Timer().start()
                out = chain(u)
                t.stop(fence=out)
                best = max(best, n * n_comp * n_iterations / t.elapsed)
            pcout(f"vmult {n * n_comp} {best:.6g}")
            res["vmult"] = best
            res["finite"]["vmult"] = bool(torch.isfinite(out).all())

        results[p] = res
        pcout("")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="CEED BP sweep (PyTorch + CUDA)")
    ap.add_argument("--bp", default="bp5", choices=[f"bp{i}" for i in range(1, 7)])
    ap.add_argument("--p-min", type=int, default=1)
    ap.add_argument("--p-max", type=int, default=8)
    ap.add_argument("--target-dofs", type=int, default=2_000_000)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--repetitions", type=int, default=3)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument(
        "--backend", default=None, choices=["banded", "stencil", "separable", "structured", "qgrid", "general"],
        help="operator backend (default: the BP's kernel, banded (K2) for BP1-BP4 and stencil (K1) for "
        "BP5/BP6; separable / structured: plain torch; qgrid: K3; general: K4, any rule)",
    )
    ap.add_argument(
        "--stream-dtype", default=None, choices=["bfloat16"],
        help="store the solver vectors at this dtype; the apply and the dots accumulate at --dtype",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run_sweep(
        args.bp,
        range(args.p_min, args.p_max + 1),
        args.target_dofs,
        args.iterations,
        args.repetitions,
        args.dtype,
        backend=args.backend,
        stream_dtype=args.stream_dtype,
        device=args.device,
    )


if __name__ == "__main__":
    main()
