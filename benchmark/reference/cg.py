"""Textbook conjugate gradients (Hestenes-Stiefel, x0 = 0, identity preconditioner) and the plain chained apply."""

from __future__ import annotations

import math

import torch

from .precision import precision

__all__ = ["PRECONDITIONERS", "cg", "chain"]

PRECONDITIONERS = ("identity",)


def cg(apply, b: torch.Tensor, max_steps: int, tolerance: float = 0.0, reduction: float = 0.0,
       prec: str = "float64", preconditioner: str = "identity"):
    """Solve ``A x = b`` from x = 0 while ``|r| > max(tolerance, reduction
    |b|)`` and fewer than ``max_steps`` iterations have run (deal.II's
    ``SolverControl`` / ``ReductionControl``). Vectors are kept at the
    precision ``prec`` names. Returns ``(x, iterations, |r|)``; ``|r|`` is
    the recurrence's residual norm. Refuses a ``preconditioner`` other
    than the identity."""
    if preconditioner not in PRECONDITIONERS:
        raise ValueError(f"the reference CG has no preconditioner {preconditioner!r}")
    dt, store, dot = precision(prec)
    b = store(b.to(dt))
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = dot(r, r)
    res0 = math.sqrt(float(rr))
    tol = max(tolerance, reduction * res0)
    it = 0
    res = res0
    while it < max_steps and res > tol:
        it += 1
        q = store(apply(p).reshape(-1).to(dt))
        alpha = rr / dot(p, q)
        x = store(x + alpha * p)
        r = store(r - alpha * q)
        rr_new = dot(r, r)
        p = store(r + (rr_new / rr) * p)
        rr = rr_new
        res = math.sqrt(float(rr))
    return x, it, res


def chain(apply, u0: torch.Tensor, length: int, prec: str = "float64") -> torch.Tensor:
    """``u <- A u``, ``length`` times, from ``u0``, stored at ``prec``."""
    dt, store, _ = precision(prec)
    u = store(u0.to(dt))
    for _ in range(length):
        u = store(apply(u).reshape(-1).to(dt))
    return u
