"""The per-iteration traffic budget of the merged CG on the card.

Counterpart of the JAX package's ``scripts/exp_solver_budget.py``, which
measured on the TPU where the solver's vector work should run. Here each
measurement is a chain of eager torch calls or kernel launches, fenced by
``torch.cuda.synchronize``, best of three, divided by the chain length, at
the BP5 shape (``BrickMesh.bp5_cycle(cycle)``, p = 5, GLL), per precision:

  (a) torch 1-pass stream, ``y = 0.999 x`` (1 read + 1 write)
  (b) torch dots pass: d.h, h.h, g.h, g.g (3 vectors read)
  (c) torch update pass: g += a h, x += a d, d = b d - g (4 reads + 3 writes)
  (d) torch solver side: dots -> scalars -> update, as in the CG body
  (e) K6, the copy probe (``ops/copy.py``): window-shaped reads, tile
      writes, beside the library call ``torch.mul(src, 2, out=dst)``
  (f) K1, the stencil apply (``ops/stencil.py``)
  (g) K1 with the value term (one more stream, a zero table)
  (h) one pcg-merged iteration (``solve_cg_merged`` on K1, K7 and K8)
  (i) one pcg-fused iteration (``solve_cg_fused`` on K5, ``ops/cg.py``)
  (j) K7, the merged CG's update pass (``ops/cg_merged.merged_update`` on
      a ``DotsWorkspace``, as the solver calls it; identity diagonal): x, g,
      d updated in place from h (4 reads + 3 writes), beside its host time
      without a workspace and its plain version, the torch update lines
  (k) K8 (``ops/cg_merged.merged_dots`` on a ``DotsWorkspace``, as the
      solver calls it): the seven sums of d, g and h (3 reads) and the
      scalars, beside its plain version and the library call ``torch.mm(V,
      V.T)`` on a stacked ``[3, n]`` of d, g and h (every identity-diagonal
      dot in one call)
  (l) the apply's wrapper on the host: ``PoissonOperator.vmult`` on K1 as
      the solver calls it (``h = A(d)``), ms a call over an unsynchronised
      chain

K7 and K8 have two times each: the card's (CUDA events around a chain that
the host queued while the card was held, ``utils/timer.cuda_time_ms``) and
the host's a call (an unsynchronised chain, best of three). GB/s figures
count the bytes the pass must move (each vector once); "eff" marks the
passes that torch runs as several launches. Run:
``python -m deal_and_ceed_on_gpu_torch.scripts.exp_solver_budget [--cycle 33]
[--chain 100] [--iterations 150] [--precisions bf16,f32,f64] [--device cpu]``
(the CPU runs the kernels' plain versions: a check of the script, not a
measurement).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..drivers.bp5 import estimate_lambda_max, resolve_device
from ..fe_space import FESpace
from ..mesh import BrickMesh
from ..models import PoissonOperator
from ..ops.cg_merged import (SUMMARY, DotsWorkspace, merged_dots, merged_dots_plain, merged_scalars_plain,
                              merged_update, merged_update_plain)
from ..ops.copy import copy_probe
from ..ops.stencil import StencilTables, stencil_apply
from ..solvers import IterationNumberControl, solve_cg_fused, solve_cg_merged
from ..utils.timer import cuda_time_ms

__all__ = ["PRECISIONS", "main", "merged_kernel_times", "run"]

DEGREE = 5
# label -> (compute dtype, storage dtype)
PRECISIONS = {
    "bf16": (torch.float32, torch.bfloat16),
    "f32": (torch.float32, torch.float32),
    "f64": (torch.float64, torch.float64),
}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _per_call(fn, n, device, reps=3):
    """Seconds per call of ``fn``: a warm-up, then the best of ``reps``
    fenced chains of ``n`` calls."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best / n


def _host_per_call(fn, n, device, reps=3):
    """Seconds the host takes per call of ``fn`` over an unsynchronised
    chain of ``n`` calls, best of ``reps`` (the card drained before each)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
    _sync(device)
    return best / n


def _kernel_times(fn, n, device) -> tuple:
    """(card, host) seconds per call of a one-launch ``fn``: CUDA events
    around a chain of ``n`` queued while the card is held, best of 3, and
    the host's unsynchronised chain; the card's is None on the CPU."""
    host = _host_per_call(fn, n, device)
    if device.type != "cuda":
        return None, host
    return 1e-3 * min(cuda_time_ms(fn, n, hold_s=2 * n * host + 1e-3) for _ in range(3)), host


def merged_kernel_times(label: str, n: int, chain: int = 100, device="cuda", seed: int = 0) -> dict:
    """Seconds per call at ``n`` points of one precision: K7 in the plain
    mode with the identity diagonal on a workspace (the summaries its rows),
    as the solver calls it, on the card (``"j"``) and on the host
    (``"j_host"``), on the host without a workspace (``"j_host_alone"``),
    its plain version (``"j_plain"``), K8 on a workspace on
    the card (``"k"``) and on the host (``"k_host"``), its plain version
    (``"k_plain"``) and ``torch.mm(V, V.T)`` on a stacked ``[3, n]`` of d,
    g and h at the storage dtype (``"k_torch"``); the plain versions and
    the library call as fenced chains. The update's scalars are fixed
    (alpha 1e-3, beta 0.5), so a chain stays bounded. On the CPU the card's
    times are None."""
    device = torch.device(device)
    cd, sd = PRECISIONS[label]
    dd = cd  # dots at the compute dtype
    rng = np.random.default_rng(seed)
    x, g, d, h = (torch.as_tensor(rng.standard_normal(n), dtype=cd, device=device).to(sd) for _ in range(4))
    ws7 = DotsWorkspace(dd, device)
    scal = ws7.next_summary()
    scal.fill_(1.0)
    scal[7:] = torch.tensor([1e-3, 0.5, 1.0, 2e-3], dtype=dd)
    out = {}
    out["j"], out["j_host"] = _kernel_times(
        lambda: merged_update(x, g, d, h, None, scal, scal, "plain", workspace=ws7), chain, device)
    out["j_host_alone"] = _host_per_call(lambda: merged_update(x, g, d, h, None, scal, scal, "plain"), chain, device)
    out["j_plain"] = _per_call(lambda: merged_update_plain(x, g, d, h, None, scal, scal, "plain"), chain, device)
    ws = DotsWorkspace(dd, device)

    def plain_dots():
        s = merged_dots_plain(d, g, h, None, None, dd)
        return torch.stack([*s, *merged_scalars_plain(s)])

    v = torch.stack([d, g, h])
    out["k"], out["k_host"] = _kernel_times(lambda: merged_dots(d, g, h, None, None, dd, workspace=ws), chain, device)
    out["k_plain"] = _per_call(plain_dots, chain, device)
    out["k_torch"] = _per_call(lambda: torch.mm(v, v.T), chain, device)
    return out


def run(label: str, cycle: int = 33, chain: int = 100, iterations: int = 150, device="cuda") -> dict:
    """Measurements (a)-(i) for one precision; prints one line each and
    returns the seconds per pass, keyed by letter (``"e_torch"`` is
    ``torch.mul``)."""
    device = torch.device(device)
    cd, sd = PRECISIONS[label]
    mesh = BrickMesh.bp5_cycle(cycle)
    space = FESpace.create(mesh, DEGREE, dtype=cd, device=device)
    op = PoissonOperator(space, backend="stencil", stream_dtype=sd)
    n = space.n_dofs
    isz = torch.empty((), dtype=sd).element_size()
    print(f"--- {label}: storage {sd}, compute {cd}, cycle {cycle}, n = {n}, grid {space.grid_shape}, "
          f"device {device}", flush=True)

    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(n)
    u = torch.as_tensor(u0 / np.linalg.norm(u0), dtype=cd, device=device).to(sd)
    x, y, z, w = u.clone(), 0.5 * u, 0.25 * u, 0.125 * u
    dd = cd  # dots accumulate at the compute dtype (f32 for bf16 vectors)
    out = {}

    def line(key, t, text):
        out[key] = t
        print(f"({key}) {text}", flush=True)

    buf = [x.clone(), torch.empty_like(x)]

    def one_pass():
        torch.mul(buf[0], 0.999, out=buf[1])
        buf.reverse()

    t = _per_call(one_pass, chain, device)
    line("a", t, f"torch 1r+1w pass: {t * 1e3:.4f} ms -> {2 * n * isz / t / 1e9:.0f} GB/s")

    def dots(d, g, h):
        hq, gq = h.to(dd), g.to(dd)
        return torch.stack([torch.dot(d.to(dd), hq), torch.dot(hq, hq), torch.dot(gq, hq), torch.dot(gq, gq)])

    t = _per_call(lambda: dots(x, y, z), chain, device)
    line("b", t, f"torch dots (3r): {t * 1e3:.4f} ms -> {3 * n * isz / t / 1e9:.0f} GB/s eff")

    state = [x.clone(), y.clone(), z.clone()]
    a_s, b_s = torch.tensor(1e-9, dtype=sd, device=device), torch.tensor(0.999, dtype=sd, device=device)

    def update(a, b):
        xs, ds, gs = state
        g2 = gs + a * w
        state[:] = [xs + a * ds, b * ds - g2, g2]

    t = _per_call(lambda: update(a_s, b_s), chain, device)
    line("c", t, f"torch update (4r+3w): {t * 1e3:.4f} ms -> {7 * n * isz / t / 1e9:.0f} GB/s eff")

    def solver_side():
        s = dots(state[1], state[2], w)
        a = (s[3] / s[0] * 1e-12).to(sd)
        b = (s[2] / s[1] * 1e-12 + 0.999).to(sd)
        update(a, b)

    t = _per_call(solver_side, chain, device)
    line("d", t, f"torch dots->scalars->update: {t * 1e3:.4f} ms -> {10 * n * isz / t / 1e9:.0f} GB/s eff")

    grid = [u.reshape(space.grid_shape).clone(), torch.empty(space.grid_shape, dtype=sd, device=device)]

    def k6():
        copy_probe(grid[0], DEGREE, out=grid[1])
        grid.reverse()

    t = _per_call(k6, chain, device)
    t_lib = _per_call(lambda: torch.mul(grid[0], 2, out=grid[1]), chain, device)
    out["e_torch"] = t_lib
    line("e", t, f"K6 copy probe (tile + halo {DEGREE} reads, tile writes): {t * 1e3:.4f} ms -> "
         f"{2 * n * isz / t / 1e9:.0f} GB/s; torch.mul {t_lib * 1e3:.4f} ms -> {2 * n * isz / t_lib / 1e9:.0f} GB/s")

    # chains of applies stay bounded with the operator scaled to radius ~1
    op.fold_scale(1.0 / estimate_lambda_max(op, n))
    v = [u.reshape(space.grid_shape).clone()]

    def k1(tables):
        v[0] = stencil_apply(v[0], tables)

    t = _per_call(lambda: k1(op._stencil), chain, device)
    line("f", t, f"K1 stencil: {t * 1e3:.4f} ms -> {n / t / 1e9:.2f} GDoF/s")
    s = op._stencil
    with_a = StencilTables(s.p, s.bz, s.by, s.bx, s.sz, s.sy, s.sx,
                           a=torch.zeros(space.grid_shape, dtype=cd, device=device))
    t = _per_call(lambda: k1(with_a), chain, device)
    line("g", t, f"K1 + value term (1 extra stream): {t * 1e3:.4f} ms -> {n / t / 1e9:.2f} GDoF/s")

    control = IterationNumberControl(iterations, 0.0)
    dot_dtype = cd if sd != cd else None
    t = _per_call(lambda: solve_cg_merged(op.vmult, u, control, dot_dtype=dot_dtype), 1, device) / iterations
    line("h", t, f"pcg-merged per iteration (K1, K7, K8): {t * 1e3:.4f} ms -> {n / t / 1e9:.2f} GDoF/s")
    t = _per_call(lambda: solve_cg_fused(op, u, control), 1, device) / iterations
    line("i", t, f"pcg-fused per iteration (K5): {t * 1e3:.4f} ms -> {n / t / 1e9:.2f} GDoF/s")

    k = merged_kernel_times(label, n, chain, device)
    out.update({key: k[key] for key in ("j_host", "j_host_alone", "j_plain", "k_host", "k_plain", "k_torch")})

    def card(t, n_bytes):
        return "not measured (no card)" if t is None else f"{t * 1e3:.4f} ms -> {n_bytes / t / 1e9:.0f} GB/s"

    line("j", k["j"], f"K7 update (4r+3w) on a workspace: card {card(k['j'], 7 * n * isz)}; host "
         f"{k['j_host'] * 1e3:.4f} ms a call ({k['j_host_alone'] * 1e3:.4f} without a workspace); plain "
         f"{k['j_plain'] * 1e3:.4f} ms")
    line("k", k["k"], f"K8 dots (3r): card {card(k['k'], 3 * n * isz)}; host {k['k_host'] * 1e3:.4f} ms a call; plain "
         f"{k['k_plain'] * 1e3:.4f} ms; torch.mm(V, V.T) {k['k_torch'] * 1e3:.4f} ms")
    flat = u.reshape(-1)
    t = _host_per_call(lambda: op.vmult(flat), chain, device)
    line("l", t, f"the apply's wrapper (PoissonOperator.vmult on K1, as the solver calls it): host {t * 1e3:.4f} ms a "
         f"call")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="merged-CG traffic budget on the card (PyTorch + CUDA)")
    ap.add_argument("--cycle", type=int, default=33)
    ap.add_argument("--chain", type=int, default=100, help="launches per timed chain")
    ap.add_argument("--iterations", type=int, default=150, help="CG iterations of (h) and (i)")
    ap.add_argument("--precisions", default=",".join(PRECISIONS))
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return {
        label: run(label, args.cycle, args.chain, args.iterations, device)
        for label in args.precisions.split(",")
    }


if __name__ == "__main__":
    main()
