"""Mapped-mesh vmult throughput on the card: K4 against K3 and the plain loop.

Counterpart of the JAX package's ``scripts/bench_general.py`` and of the
mapped case of its ``scripts/bench_qgrid.py``:

- the sine-mapped brick (``sine_map(0.05)`` on ``BrickMesh((m, m, m))``,
  m = 52 by default: 3,869,893 DoFs), p = 3, Gauss q = 4, Poisson, on the
  backends ``structured`` (the plain torch cell loop), ``general`` (K4) and
  ``qgrid`` (K3 with real ``full6`` tables);
- BP3 (p = 5, Gauss q = 7, uniform 32^3 brick) on ``general`` (K4, grad
  ``const``).

``--mesh graded`` takes the graded brick of the JAX ``bench_qgrid.py``
"graded" case instead (element widths ``0.6 + U[0, 1)`` from seed 7, the
same on every axis): ``diag3`` tables on K3. ``--coef-dtype bfloat16``
stores K3's planes in bf16 (the JAX ``bench_qgrid.py`` ``coef_sd``, its
"mapped_bf16" case): f32 vectors only, so the f32 lines alone run.

Each line is the best of 3 chained runs of ``--applies`` (50) applies, fenced with ``torch.cuda.synchronize``, after ``fold_scale(1 /
max(|A u|, 1))`` so that every step is one pure apply; throughput = DoFs x
applies / wall time. ``--split`` adds one ``general`` apply's split into
gather, K4 and scatter (CUDA events). Run:
``python -m deal_and_ceed_on_gpu_torch.scripts.bench_general [--elements 52]
[--bp3-elements 32] [--applies 50] [--split] [--mesh mapped|graded]
[--coef-dtype bfloat16] [--device cpu]`` (the CPU runs the plain versions:
a check of the script, not a measurement).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..drivers.bp5 import DTYPES, resolve_device
from ..fe_space import FESpace
from ..mesh import BrickMesh, sine_map
from ..models import PoissonOperator
from ..ops import local_global as lg
from ..utils.logging import rank0_print as pcout

__all__ = ["apply_split_ms", "bench_mesh", "measure", "run"]

BACKENDS = ("structured", "general", "qgrid")
MESHES = ("mapped", "graded")
REPETITIONS = 3


def bench_mesh(kind: str, n_elements: int) -> BrickMesh:
    """The benchmark's brick of ``n_elements`` a side: ``mapped``
    (``sine_map(0.05)``, full6 tables) or ``graded`` (the JAX
    ``bench_qgrid.py`` widths ``0.6 + U[0, 1)`` from seed 7 on every axis,
    diag3 tables)."""
    if kind == "mapped":
        return BrickMesh((n_elements,) * 3).deform(*sine_map(0.05))
    if kind == "graded":
        edges = np.cumsum(np.concatenate([[0.0], 0.6 + np.random.default_rng(7).random(n_elements)]))
        return BrickMesh.graded(edges, edges, edges)
    raise ValueError(f"mesh {kind!r}: expected one of {MESHES}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(op, n_applies: int = 50) -> float:
    """DoF/s of chained ``op.vmult``: best of ``REPETITIONS`` chains of
    ``n_applies``, after folding ``1 / max(|A u|, 1)`` into the operator."""
    space = op.space
    u0 = torch.as_tensor(np.random.default_rng(0).standard_normal(space.n_dofs), dtype=space.dtype,
                         device=space.device)
    u0 = u0 / torch.linalg.vector_norm(u0)
    op.fold_scale(1.0 / max(float(torch.linalg.vector_norm(op.vmult(u0))), 1.0))
    op.vmult(u0)
    best = 0.0
    for _ in range(REPETITIONS):
        _sync(space.device)
        t0 = time.perf_counter()
        w = u0
        for _ in range(n_applies):
            w = op.vmult(w)
        _sync(space.device)
        best = max(best, space.n_dofs * n_applies / (time.perf_counter() - t0))
    return best


def apply_split_ms(op, n: int = 20) -> dict:
    """One ``general`` apply's parts on the card, ms each (CUDA events over
    ``n`` calls): the element-major gather, K4, the overlap-add scatter."""
    k, s = op._general, op.space
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(s.grid_shape), dtype=s.dtype, device=s.device)
    ul = lg.gather_elements(u, s.mesh.n_elements, s.degree)
    wl = k.apply_local(ul)
    parts = {
        "gather": lambda: lg.gather_elements(u, s.mesh.n_elements, s.degree),
        "K4": lambda: k.apply_local(ul, out=wl),
        "scatter": lambda: lg.scatter_elements(wl, s.mesh.n_elements, s.degree),
        "whole": lambda: op.vmult(u.reshape(-1)),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize(s.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(s.device)
        out[name] = start.elapsed_time(end) / n
    return out


def run(n_elements: int = 52, dtypes=("float64", "float32"), backends=BACKENDS, bp3_elements: int = 32,
        n_applies: int = 50, split: bool = False, device="cuda", mesh: str = "mapped",
        coef_dtype: str | None = None) -> dict:
    """The ``mesh`` vmult lines, then BP3 on ``general``; returns
    ``{(case, dtype): DoF/s}`` (and ``{("split", dtype): {...}}``).
    ``coef_dtype`` ("bfloat16") stores the ``qgrid`` backend's planes at
    that dtype (f32 vectors only; its case is ``"<mesh> p3 qgrid
    bfloat16"``)."""
    dev = resolve_device(str(device))
    pcout(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu (plain versions)'}")
    out = {}
    brick = bench_mesh(mesh, n_elements)
    for dtype in dtypes:
        space = FESpace.create(brick, 3, n_q=4, rule="gauss", dtype=DTYPES[dtype], device=dev)
        for backend in backends:
            narrow = coef_dtype is not None and backend == "qgrid"
            op = PoissonOperator(space, backend=backend, **({"coef_dtype": DTYPES[coef_dtype]} if narrow else {}))
            tp = measure(op, n_applies)
            name = f"{backend} {coef_dtype}" if narrow else backend
            out[(f"{mesh} p3 {name}", dtype)] = tp
            pcout(f"{mesh} p3 q4 {n_elements}^3 {name:10s} {dtype}: {tp / 1e9:.4f} GDoF/s ({space.n_dofs} DoFs)")
            if split and backend == "general" and dev.type == "cuda":
                parts = apply_split_ms(op)
                out[("split", dtype)] = parts
                pcout(f"{mesh} p3 general apply split, ms: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
            del op
        if bp3_elements:
            bp3 = FESpace.create(BrickMesh((bp3_elements,) * 3), 5, n_q=7, rule="gauss", dtype=DTYPES[dtype],
                                 device=dev)
            tp = measure(PoissonOperator(bp3, backend="general"), n_applies)
            out[("BP3 p5 q7 general", dtype)] = tp
            pcout(f"BP3 p5 q7 {bp3_elements}^3 general    {dtype}: {tp / 1e9:.4f} GDoF/s ({bp3.n_dofs} DoFs)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="mapped-mesh vmult on K4, K3 and the plain loop (PyTorch + CUDA)")
    ap.add_argument("--elements", type=int, default=52, help="elements per axis of the mapped brick")
    ap.add_argument("--bp3-elements", type=int, default=32, help="elements per axis of the BP3 cube (0: skip)")
    ap.add_argument("--applies", type=int, default=50)
    ap.add_argument("--split", action="store_true", help="time gather, K4 and scatter of one general apply")
    ap.add_argument("--mesh", default="mapped", choices=MESHES,
                    help="mapped: sine_map(0.05), full6 tables; graded: random widths, diag3 tables")
    ap.add_argument("--coef-dtype", default=None, choices=["bfloat16"],
                    help="store K3's coefficient planes (the qgrid backend) at this dtype; f32 lines only")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dtypes = ("float32",) if args.coef_dtype else ("float64", "float32")
    return run(args.elements, dtypes, bp3_elements=args.bp3_elements, n_applies=args.applies, split=args.split,
               device=args.device, mesh=args.mesh, coef_dtype=args.coef_dtype)


if __name__ == "__main__":
    main()
