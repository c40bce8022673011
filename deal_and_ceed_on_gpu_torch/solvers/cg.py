"""Baseline preconditioned conjugate gradients — the "pcg-standard" mode.

Counterpart of ``deal_and_ceed_on_gpu_tpu/solvers/cg.py``: textbook PCG
(deal.II ``SolverCG`` as used at ``bp5/step-64.cu:434-475``) with separate
AXPY-style updates and 2-3 reductions per iteration, the unfused comparator
of ``cg_merged.py``. The scalars stay on the device; the loop reads the
residual norm on the host once per iteration for the stopping test.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .control import SolverControl

__all__ = ["solve_cg", "safe_div"]


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den``, and 0 where ``den == 0`` (exact convergence stops the
    loop cleanly instead of dividing by zero, cf. ``bp5/solver.h:501``)."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)), torch.zeros_like(num))


def solve_cg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    control: SolverControl,
    diag: Optional[torch.Tensor | Callable] = None,
    x0: Optional[torch.Tensor] = None,
    dot_dtype: Optional[torch.dtype] = None,
    dot_weight: Optional[torch.Tensor] = None,
    comm=None,
):
    """Solve A x = b with Jacobi-preconditioned CG.

    Returns ``(x, info)`` with ``info = {"n_iterations": int, "res_norm",
    "res0"}`` (device scalars). ``diag`` is multiplied like the reference's
    ``DiagonalMatrix`` (both drivers fill it with 1.0,
    ``bp5/step-64.cu:428-432``; None is that identity without a vector); it
    may also be a callable preconditioner. ``dot_dtype``: accumulation dtype
    of the dot products and scalars (float32 for bfloat16 vectors). The
    vectors may have any shape (``[3, n]`` for the vector BPs): the dots run
    over all entries, as the JAX solvers' ``jnp.sum`` does.

    Distributed (``parallel/dist_solve.py``): the vectors are a rank's
    ghosted block, ``dot_weight`` (broadcastable to them) zeroes the
    duplicated planes in the dots and ``comm`` (a ``ShardComm``) sums them
    over the ranks, the residual norm and ``r.z`` in one all-reduce (JAX's
    ``dot_weight`` / ``psum_axis``)."""
    dt = b.dtype
    dd = dot_dtype or dt

    def dot(u, v):
        # over all entries: a [3, n] vector solves like a flat one
        return torch.dot(u.to(dd).reshape(-1), v.to(dd).reshape(-1))

    if comm is not None:
        w = None if dot_weight is None else dot_weight.to(dd)

        def local(u, v):
            uq = u.to(dd)
            return dot(uq if w is None else uq * w, v)

        def dots(*pairs):
            # the local dots of every pair in one all-reduce
            return comm.allreduce_sum_(torch.stack([local(u, v) for u, v in pairs])).unbind()
    else:
        def dots(*pairs):
            return tuple(dot(u, v) for u, v in pairs)

    if callable(diag):
        precond = diag
    elif diag is None:
        precond = lambda r: r  # noqa: E731
    else:
        precond = lambda r: diag * r  # noqa: E731

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)

    z = precond(r)
    rr, rz = dots((r, r), (r, z))
    res0 = torch.sqrt(rr)
    res = res0
    d = z
    it = 0
    res0_h = float(res0)
    res_h = res0_h
    while control.continue_pred(it, res_h, res0_h):
        h = A(d)
        (dh,) = dots((d, h))
        alpha = safe_div(rz, dh).to(dt)
        x = x + alpha * d
        r = r - alpha * h
        z = precond(r)
        rz_new, rr = dots((r, z), (r, r))
        beta = safe_div(rz_new, rz).to(dt)
        d = z + beta * d
        rz = rz_new
        res = torch.sqrt(rr)
        it += 1
        res_h = float(res)  # the one host read per iteration
    return x, {"n_iterations": it, "res_norm": res, "res0": res0}
