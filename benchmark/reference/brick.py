"""The Q_p operator on a uniform brick, element by element in plain PyTorch.

``BrickOperator`` applies ``-div(grad u) + a(x) u`` (Poisson where there is
no coefficient) with zero Dirichlet rows acting as the identity, the
convention of deal.II's constrained ``vmult``: ``A_c u = M A (M u) + (I - M) u``
with ``M`` the interior mask. Each element's integral is taken at the
quadrature points by sum factorisation with the 1D tables of
``reference/basis.py``: the nodal values are gathered into
``[mz, p+1, my, p+1, mx, p+1]`` (element and node index of z, y, x), the
1D tables contracted along each node axis, the quadrature weights, the
Jacobian and the coefficient applied, the transposed tables contracted
back, and the element vectors added into the global grid ``[nz, ny, nx]``
(x fastest). Nothing here is shared with the program.

``load_vector`` is the right-hand side ``b_i = integral(f phi_i)`` of a
smooth field ``f`` that the seed draws (``field_params``), integrated by
the same quadrature.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .basis import tables

__all__ = ["BrickOperator", "COEFFICIENTS", "field_params", "load_vector", "seed_int"]


def _step64(x, y, z):
    """a(x) = 10 / (0.05 + 2 |x|^2), deal.II step-64's coefficient."""
    return 10.0 / (0.05 + 2.0 * (x * x + y * y + z * z))


COEFFICIENTS = {"step64": _step64}


def seed_int(*words: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from the run's seed and indices
    (any whole numbers, negative ones included)."""
    ss = np.random.SeedSequence([w % 2**64 for w in words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _contract(t: torch.Tensor, M: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[.., q, ..] = sum_i M[q, i] t[.., i, ..]`` along ``axis``."""
    return torch.movedim(torch.tensordot(t, M, dims=([axis], [1])), -1, axis)


def _fold_last2(t: torch.Tensor) -> torch.Tensor:
    """``[..., m, p+1]`` element values -> ``[..., m p + 1]`` grid values:
    an element's last node is the next element's first, and their values add."""
    m, p1 = t.shape[-2:]
    p = p1 - 1
    lead = t.shape[:-2]
    out = t.new_zeros(lead + (m * p + 1,))
    out[..., : m * p] = t[..., :p].reshape(lead + (m * p,))
    out[..., p::p] += t[..., p]
    return out


class BrickOperator:
    """``mesh``: ``{"n_elements": [mx, my, mz], "lower": [..], "upper": [..]}``;
    Q_``degree`` on GLL nodes with an ``n_q``-point ``rule``; ``coefficient``:
    a name of ``COEFFICIENTS`` for the value term, or None; ``scale``
    multiplies the unconstrained rows (the chained vmult's factor).
    Computes at ``dtype``; matrix products run without TF32."""

    def __init__(self, mesh: dict, degree: int, n_q: int, rule: str, coefficient: str | None = None,
                 dtype=torch.float64, device="cpu", scale: float = 1.0):
        self.m = tuple(int(v) for v in mesh["n_elements"])  # (mx, my, mz)
        self.lower = tuple(float(v) for v in mesh["lower"])
        self.upper = tuple(float(v) for v in mesh["upper"])
        self.p = int(degree)
        self.dtype = dtype
        self.device = torch.device(device)
        mx, my, mz = self.m
        p = self.p
        self.grid = (mz * p + 1, my * p + 1, mx * p + 1)
        S, D, self._pts, w, self.collocated = tables(p, n_q, rule)
        self.q = len(w)
        self.h = tuple((self.upper[d] - self.lower[d]) / self.m[d] for d in range(3))  # (hx, hy, hz)
        hx, hy, hz = self.h
        det = hx * hy * hz
        q = self.q
        w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(1, q, 1, q, 1, q)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)  # noqa: E731
        self.S, self.D = t(S), t(D)
        self.gx = t(scale * det / hx**2 * w3)
        self.gy = t(scale * det / hy**2 * w3)
        self.gz = t(scale * det / hz**2 * w3)
        self.w3det = t(det * w3)
        self.value = None
        if coefficient is not None:
            X, Y, Z = self.quad_coords(torch.float64)
            self.value = (scale * COEFFICIENTS[coefficient](X, Y, Z) * t(det * w3).to(torch.float64)).to(dtype)
        nz, ny, nx = self.grid
        mask = torch.zeros(self.grid, dtype=torch.bool, device=self.device)
        mask[1:nz - 1, 1:ny - 1, 1:nx - 1] = True
        self.mask = mask

    @property
    def n_dofs(self) -> int:
        return math.prod(self.grid)

    def quad_coords(self, dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The physical x, y, z of every element's quadrature points, shaped
        to broadcast over ``[mz, q, my, q, mx, q]``."""
        out = []
        for d, shape in ((0, (1, 1, 1, 1, -1, self.q)), (1, (1, 1, -1, self.q, 1, 1)), (2, (-1, self.q, 1, 1, 1, 1))):
            e = np.arange(self.m[d])[:, None]
            xs = self.lower[d] + (e + self._pts[None, :]) * self.h[d]
            out.append(torch.as_tensor(xs, dtype=dtype, device=self.device).reshape(shape))
        return tuple(out)

    def gather(self, u: torch.Tensor) -> torch.Tensor:
        """``[nz, ny, nx]`` -> ``[mz, p+1, my, p+1, mx, p+1]`` (a copy)."""
        p, p1 = self.p, self.p + 1
        e = u.unfold(0, p1, p).unfold(1, p1, p).unfold(2, p1, p)  # [mz, my, mx, p1z, p1y, p1x]
        return e.permute(0, 3, 1, 4, 2, 5).contiguous()

    def scatter(self, v: torch.Tensor) -> torch.Tensor:
        """``[mz, p+1, my, p+1, mx, p+1]`` -> ``[nz, ny, nx]``, shared nodes added."""
        v = _fold_last2(v)  # x: [mz, p1, my, p1, nx]
        v = _fold_last2(v.permute(0, 1, 4, 2, 3))  # y: [mz, p1, nx, ny]
        v = _fold_last2(v.permute(2, 3, 0, 1))  # z: [nx, ny, nz]
        return v.permute(2, 1, 0)

    def _interp(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        return t if self.collocated else _contract(t, self.S, axis)

    def _interp_t(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        return t if self.collocated else _contract(t, self.S.T, axis)

    def integrate(self, vals: torch.Tensor | None, gx=None, gy=None, gz=None) -> torch.Tensor:
        """The element vectors ``sum_q (vals phi_i + g . grad phi_i)`` of
        quadrature-point integrands (weights already applied), assembled
        into the grid with no constraint applied."""
        Dt = self.D.T
        z1 = None
        if gz is not None:
            z1 = _contract(gz, Dt, 1)
        if vals is not None:
            iv = self._interp_t(vals, 1)
            z1 = iv if z1 is None else z1 + iv
        y1 = self._interp_t(z1, 3) if z1 is not None else None
        if gy is not None:
            dy = _contract(self._interp_t(gy, 1), Dt, 3)
            y1 = dy if y1 is None else y1 + dy
        out = self._interp_t(y1, 5) if y1 is not None else None
        if gx is not None:
            dx = _contract(self._interp_t(self._interp_t(gx, 1), 3), Dt, 5)
            out = dx if out is None else out + dx
        return self.scatter(out)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """``A_c u`` for ``u`` of shape ``[nz, ny, nx]`` or flat, at ``dtype``."""
        with _no_tf32():
            u = u.reshape(self.grid).to(self.dtype)
            ul = self.gather(torch.where(self.mask, u, torch.zeros((), dtype=self.dtype, device=u.device)))
            sx = self._interp(ul, 5)
            a = self._interp(sx, 3)
            ux = self._interp(self._interp(_contract(ul, self.D, 5), 3), 1)
            uy = self._interp(_contract(sx, self.D, 3), 1)
            uz = _contract(a, self.D, 1)
            vals = None if self.value is None else self._interp(a, 1) * self.value
            out = self.integrate(vals, ux * self.gx, uy * self.gy, uz * self.gz)
            return torch.where(self.mask, out, u)

    def integrate_field(self, f) -> torch.Tensor:
        """``b_i = integral(f phi_i)`` on the unconstrained rows, 0 on the
        constrained ones, at ``dtype``; ``f(x, y, z)`` takes the broadcast
        quadrature coordinates."""
        with _no_tf32():
            X, Y, Z = self.quad_coords(self.dtype)
            b = self.integrate(f(X, Y, Z) * self.w3det)
            return torch.where(self.mask, b, torch.zeros((), dtype=self.dtype, device=b.device))


class _no_tf32:
    """Matrix products at full float32 precision inside the block (the
    caller's settings come back on exit)."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False


def field_params(seed: int, index: int, modes: int = 3) -> list[tuple]:
    """The smooth load ``f = 1 + sum_k c_k cos(2 pi n_k . xhat + phi_k)`` of
    right-hand side ``index``: integer wave vectors n_k in [0, 3]^3,
    amplitudes c_k in [-0.3, 0.3], phases in [0, 2 pi), over the brick's
    normalised coordinates xhat. f stays above 0.1."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, index % 2**64]))
    return [(tuple(int(v) for v in rng.integers(0, 4, 3)), float(rng.uniform(-0.3, 0.3)),
             float(rng.uniform(0.0, 2 * math.pi))) for _ in range(modes)]


def load_vector(op, params: list[tuple]) -> torch.Tensor:
    """The right-hand side of ``field_params`` on ``op``'s mesh, flat, at
    ``op.dtype``: ``op`` gives the bounds ``lower`` and ``upper`` that
    normalise the coordinates and ``integrate_field`` (``BrickOperator``'s)."""
    lo, hi = op.lower, op.upper

    def f(X, Y, Z):
        out = torch.ones_like(X * Y * Z)
        for (nx, ny, nz), c, phi in params:
            arg = 2 * math.pi * (nx * (X - lo[0]) / (hi[0] - lo[0]) + ny * (Y - lo[1]) / (hi[1] - lo[1])
                                 + nz * (Z - lo[2]) / (hi[2] - lo[2])) + phi
            out = out + c * torch.cos(arg)
        return out

    return op.integrate_field(f).reshape(-1)
