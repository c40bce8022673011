"""The sweep behind ``drivers/bp5.py --backend auto``: K1 against the plain
``separable`` backend over the BP5 cycles.

Counterpart of the JAX package's measured solver-selection guidance (its
``drivers/bp5.py:125-143`` thresholds came from TPU cycle sweeps). For each
``bp5_cycle(c)``, ``c`` in ``--cycle-min`` .. ``--cycle-max`` (7..40: 1,936
to 131,892,801 DoFs), p = 5, GLL collocation, and each precision (f64, f32, f32
compute with bf16-streamed vectors), it times

- ``vmult``: a chain of ``n`` applies, ``1 / lambda_est`` folded into the
  operator (``fold_scale``) so nothing overflows;
- ``pcg-merged``: ``n`` merged-CG iterations (tolerance 0);

on ``stencil`` (K1) and ``separable`` in turns (separable, stencil,
stencil, separable), each fenced with ``torch.cuda.synchronize``, and keeps
each backend's best ms an apply and ms an iteration. ``n`` is 100 below
20M DoFs, fewer above (at least 10). The threshold of a precision is the
DoFs of the smallest cycle from which K1 is at least as fast in vmult at
that cycle and at every larger one (0 when it is so at every cycle swept):
the backend is the operator apply, and every mode runs the same solver
code around it; below ~4M DoFs a pcg-merged iteration is host-bound
(0.4-1.0 ms on either backend, one host read an iteration), so its
readings of the two backends cross by noise there. pcg-merged's crossing
is printed alongside. Run on the card:
``python -m deal_and_ceed_on_gpu_torch.scripts.sweep_auto [--cycle-min 7]
[--cycle-max 40] [--out sweep.json]`` (``--device cpu`` runs the plain
versions at small cycles: a check of the script, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..drivers.bp5 import DTYPES, estimate_lambda_max, resolve_device
from ..fe_space import FESpace
from ..mesh import BrickMesh
from ..models import PoissonOperator, assemble_rhs
from ..solvers import IterationNumberControl, solve_cg_merged
from ..utils.logging import rank0_print as pcout

__all__ = ["PRECISIONS", "run", "thresholds"]

DEGREE = 5
BACKENDS = ("separable", "stencil")
# (label, dtype, stream dtype): the keys of drivers/bp5.AUTO_THRESHOLDS
PRECISIONS = (("f64", "float64", None), ("f32", "float32", None), ("bf16", "float32", "bfloat16"))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _n_steps(n_dofs: int) -> int:
    return max(10, min(100, int(2e9 // n_dofs)))


def _time_backends(space, stream, n, device):
    """Best ms an apply (vmult) and an iteration (pcg-merged) per backend,
    in turns."""
    dtype = space.dtype
    ops = {b: PoissonOperator(space, backend=b, stream_dtype=None if stream == dtype else stream) for b in BACKENDS}
    for op in ops.values():
        op.fold_scale(1.0 / estimate_lambda_max(op, space.n_dofs))
    b = assemble_rhs(space, 1.0)
    b_s = b.to(stream)
    u0 = (b / torch.linalg.vector_norm(b)).to(stream)
    control = IterationNumberControl(n, 0.0)
    dot_dtype = dtype if stream != dtype else None

    def vmult(op):
        u = u0
        for _ in range(n):
            u = op.vmult(u)
        return u

    def cg(op):
        return solve_cg_merged(op.vmult, b_s, control, dot_dtype=dot_dtype)[0]

    best = {}
    for backend in BACKENDS + BACKENDS[::-1]:
        for mode, fn in (("vmult", vmult), ("pcg-merged", cg)):
            if (backend, mode) not in best:
                fn(ops[backend])  # warm-up
            _sync(device)
            t0 = time.perf_counter()
            out = fn(ops[backend])
            _sync(device)
            ms = 1e3 * (time.perf_counter() - t0) / n
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"sweep: {backend} {mode} gave a non-finite result")
            best[(backend, mode)] = min(best.get((backend, mode), float("inf")), ms)
    return best


def thresholds(rows) -> dict:
    """Per precision label and mode (vmult: the threshold; pcg-merged): the
    DoFs from which K1 is at least as fast as separable at every cycle
    swept (0 if at all of them; None if at none). ``rows``: ``run``'s
    list."""
    out = {}
    for label, _, _ in PRECISIONS:
        mine = sorted((r for r in rows if r["precision"] == label), key=lambda r: r["n_dofs"])
        out[label] = {}
        for mode in ("pcg-merged", "vmult"):
            thresh = None
            for r in reversed(mine):
                if r[f"stencil {mode} ms"] > r[f"separable {mode} ms"]:
                    break
                thresh = r["n_dofs"]
            if thresh == mine[0]["n_dofs"]:
                thresh = 0  # K1 at least as fast at every cycle swept
            out[label][mode] = thresh
    return out


def run(cycle_min: int = 7, cycle_max: int = 40, device="cuda", precisions=PRECISIONS) -> list:
    """The sweep; returns one row a (cycle, precision) with both backends'
    best ms an apply and an iteration."""
    dev = resolve_device(str(device))
    pcout(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu (plain versions)'}")
    rows = []
    for cycle in range(cycle_min, cycle_max + 1):
        mesh = BrickMesh.bp5_cycle(cycle)
        for label, dtype, stream in precisions:
            space = FESpace.create(mesh, DEGREE, dtype=DTYPES[dtype], device=dev)
            n = _n_steps(space.n_dofs)
            best = _time_backends(space, DTYPES[stream or dtype], n, dev)
            row = {"cycle": cycle, "n_dofs": space.n_dofs, "precision": label, "steps": n}
            row.update({f"{b} {m} ms": v for (b, m), v in best.items()})
            rows.append(row)
            pcout(f"cycle {cycle:2d} {space.n_dofs:10d} DoFs {label:4s} n={n:3d}: vmult stencil "
                  f"{row['stencil vmult ms']:.4f} separable {row['separable vmult ms']:.4f} ms; pcg-merged stencil "
                  f"{row['stencil pcg-merged ms']:.4f} separable {row['separable pcg-merged ms']:.4f} ms/it")
            del space, best
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="BP5 stencil (K1) vs separable over the cycles: auto's thresholds")
    ap.add_argument("--cycle-min", type=int, default=7)
    ap.add_argument("--cycle-max", type=int, default=40)
    ap.add_argument("--out", default=None, help="write the rows and thresholds here as JSON")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.cycle_min, args.cycle_max, args.device)
    th = thresholds(rows)
    for label, modes in th.items():
        pcout(f"threshold {label}: {modes['vmult']} DoFs (vmult); pcg-merged's crossing {modes['pcg-merged']} DoFs")
    if args.out:
        card = torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda" else "cpu"
        with open(args.out, "w") as f:
            json.dump({"device": card, "rows": rows, "thresholds": th}, f, indent=1)
    return rows, th


if __name__ == "__main__":
    main()
