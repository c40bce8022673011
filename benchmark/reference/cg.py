"""Textbook (preconditioned) conjugate gradients (Hestenes-Stiefel, x0 = 0, a diagonal preconditioner or none)
and the plain chained apply."""

from __future__ import annotations

import math

import torch

from .precision import precision

__all__ = ["cg", "chain"]


def cg(apply, b: torch.Tensor, max_steps: int, tolerance: float = 0.0, reduction: float = 0.0,
       prec: str = "float64", diag: torch.Tensor | None = None):
    """Solve ``A x = b`` from x = 0 while ``|r| > max(tolerance, reduction
    |b|)`` and fewer than ``max_steps`` iterations have run (deal.II's
    ``SolverControl`` / ``ReductionControl``), preconditioned by ``z = diag
    r`` (``diag`` a flat vector, or None: plain CG). Vectors, ``diag`` too,
    are kept at the precision ``prec`` names. Returns ``(x, iterations,
    |r|)``; ``|r|`` is the recurrence's residual 2-norm, which the stopping
    test reads with a diagonal too (as the program's merged CG does)."""
    dt, store, dot = precision(prec)
    m = None if diag is None else store(diag.reshape(-1).to(dt))
    b = store(b.to(dt))
    x = torch.zeros_like(b)
    r = b.clone()
    z = r if m is None else store(m * r)
    p = z.clone()
    rz = dot(r, z)
    rr = rz if m is None else dot(r, r)
    res0 = math.sqrt(float(rr))
    tol = max(tolerance, reduction * res0)
    it = 0
    res = res0
    while it < max_steps and res > tol:
        it += 1
        q = store(apply(p).reshape(-1).to(dt))
        alpha = rz / dot(p, q)
        x = store(x + alpha * p)
        r = store(r - alpha * q)
        z = r if m is None else store(m * r)
        rz_new = dot(r, z)
        rr = rz_new if m is None else dot(r, r)
        p = store(z + (rz_new / rz) * p)
        rz = rz_new
        res = math.sqrt(float(rr))
    return x, it, res


def chain(apply, u0: torch.Tensor, length: int, prec: str = "float64") -> torch.Tensor:
    """``u <- A u``, ``length`` times, from ``u0``, stored at ``prec``."""
    dt, store, _ = precision(prec)
    u = store(u0.to(dt))
    for _ in range(length):
        u = store(apply(u).reshape(-1).to(dt))
    return u
