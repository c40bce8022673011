"""Local <-> global DoF transfer on a structured brick: gather
(``read_dof_values``) and scatter-add (``distribute_local_to_global``).

Counterpart of the structured path of
``deal_and_ceed_on_gpu_tpu/ops/local_global.py``. On a lexicographic brick
grid the local<->global map is axis-separable. Along one axis with ``m``
elements of degree ``p`` (``n = m*p + 1`` global nodes), element ``e``
touches nodes ``[e*p, e*p + p]``, so

- gather  = a reshape of the first ``m*p`` entries plus one strided slice,
- scatter = the reverse overlap-add: shift the last-node column by one
  element and add it onto the first-node column.

Both are dense slices/concats: no indices, no atomics, deterministic (the
reference resolves the same write conflicts with ``atomicAdd`` or graph
colouring, ``bp5/fe_evaluation_gl.h:162-181``). The 3D version applies this
per axis, giving the interleaved local layout ``[mz, p+1, my, p+1, mx, p+1]``.
The element-major form ``[E, (p+1)^3]`` of the general cell kernel (K4,
``ops/general.py``) is one strided copy away: ``gather_elements`` reads the
overlapping windows with ``unfold`` (one copy), ``scatter_elements`` views
them back in the interleaved layout and overlap-adds as above.
"""

from __future__ import annotations

import torch

__all__ = [
    "split_axis",
    "join_axis",
    "gather_structured",
    "scatter_structured",
    "gather_elements",
    "scatter_elements",
]


def split_axis(u: torch.Tensor, axis: int, m: int, p: int) -> torch.Tensor:
    """Gather along one axis: size ``m*p+1`` -> two axes ``(m, p+1)`` of
    per-element local nodes (shared nodes duplicated). The new pair replaces
    ``axis`` in place."""
    axis = axis % u.dim()
    u = torch.movedim(u, axis, -1)
    main = u[..., : m * p].reshape(u.shape[:-1] + (m, p))
    last = u[..., p::p].unsqueeze(-1)  # nodes p, 2p, ..., m*p
    out = torch.cat([main, last], dim=-1)  # [..., m, p+1]
    return torch.movedim(out, (-2, -1), (axis, axis + 1))


def join_axis(v: torch.Tensor, axis: int, p: int) -> torch.Tensor:
    """Scatter-add along one axis: two axes ``(m, p+1)`` at ``(axis, axis+1)``
    -> one global axis ``m*p+1`` with overlap-added shared nodes. Exact
    reverse of :func:`split_axis`."""
    axis = axis % v.dim()
    v = torch.movedim(v, (axis, axis + 1), (-2, -1))
    m = v.shape[-2]
    a = v[..., :p]  # [..., m, p]
    b = v[..., p]  # [..., m] last local node of each element
    # node e*p (e >= 1) receives a[e, 0] + b[e-1]; node 0 receives a[0, 0]
    shifted = torch.cat([torch.zeros_like(b[..., :1]), b[..., :-1]], dim=-1)
    first = a[..., 0] + shifted
    body = torch.cat([first.unsqueeze(-1), a[..., 1:]], dim=-1)
    out = torch.cat(
        [body.reshape(body.shape[:-2] + (m * p,)), b[..., -1:]], dim=-1
    )  # [..., m*p+1]
    return torch.movedim(out, -1, axis)


def gather_structured(u: torch.Tensor, n_elements, p: int) -> torch.Tensor:
    """``[nz, ny, nx]`` global nodal grid -> interleaved element-local tensor
    ``[mz, p+1, my, p+1, mx, p+1]``."""
    mx, my, mz = n_elements
    u = split_axis(u, 0, mz, p)  # [mz, p1, ny, nx]
    u = split_axis(u, 2, my, p)  # [mz, p1, my, p1, nx]
    u = split_axis(u, 4, mx, p)  # [mz, p1, my, p1, mx, p1]
    return u


def scatter_structured(v: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse overlap-add of :func:`gather_structured`:
    ``[mz, p+1, my, p+1, mx, p+1]`` -> ``[nz, ny, nx]``."""
    v = join_axis(v, 4, p)  # [mz, p1, my, p1, nx]
    v = join_axis(v, 2, p)  # [mz, p1, ny, nx]
    v = join_axis(v, 0, p)  # [nz, ny, nx]
    return v


def gather_elements(u: torch.Tensor, n_elements, p: int) -> torch.Tensor:
    """``[nz, ny, nx]`` global nodal grid -> element-major local vectors
    ``[E, (p+1)^3]``: cells (ez, ey, ex), local DoFs (k, j, i), x fastest
    (the transpose at ``pallas_general.py:366-369``, in one copy)."""
    mx, my, mz = n_elements
    p1 = p + 1
    w = u.unfold(0, p1, p).unfold(1, p1, p).unfold(2, p1, p)  # [mz, my, mx, p1, p1, p1]
    return w.reshape(mx * my * mz, p1**3)


def scatter_elements(w: torch.Tensor, n_elements, p: int) -> torch.Tensor:
    """Overlap-add of element-major local vectors ``[E, (p+1)^3]`` ->
    ``[nz, ny, nx]`` (``pallas_general.py:371-372``)."""
    mx, my, mz = n_elements
    p1 = p + 1
    w6 = w.reshape(mz, my, mx, p1, p1, p1).permute(0, 3, 1, 4, 2, 5)
    return scatter_structured(w6, p)
