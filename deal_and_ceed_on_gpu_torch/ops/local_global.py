"""Local <-> global DoF transfer: gather (``read_dof_values``) and
scatter-add (``distribute_local_to_global``).

Counterpart of ``deal_and_ceed_on_gpu_tpu/ops/local_global.py``.

**Structured (index-free).** On a lexicographic brick grid the
local<->global map is axis-separable. Along one axis with ``m`` elements of
degree ``p`` (``n = m*p + 1`` global nodes), element ``e`` touches nodes
``[e*p, e*p + p]``, so

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

**Indexed (general).** An explicit ``local_to_global`` table ``[E,
(p+1)^3]`` (adaptive meshes, the ``gather`` backend): the gather is one
``index_select``. The scatter-add must not use ``index_add_`` /
``scatter_add_``: on a CUDA tensor those accumulate with atomics, in an
order that changes from run to run. The JAX package's scatters combine
duplicates in a fixed order (XLA scatter-add, the sorted ``segment_sum``);
the port gets the same with a :class:`SumPlan` built once on the host: the
local positions sorted by their global index (a stable sort) and laid out
as rows of one padded table (a row per output, as wide as the most
positions one output receives, padding reading a zero), so a scatter is one
permutation gather and one row sum in a fixed order. The hanging-node
``distribute`` / ``condense`` of ``adaptive.py`` are the same table with
weights. No process-global flag is involved.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "split_axis",
    "join_axis",
    "gather_structured",
    "scatter_structured",
    "gather_elements",
    "scatter_elements",
    "SumPlan",
    "make_sum_plan",
    "make_scatter_plan",
    "gather_indexed",
    "scatter_indexed",
    "scatter_indexed_sorted",
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


# --------------------------------------------------------------------- #
# indexed (general) backend
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SumPlan:
    """A deterministic weighted segment sum ``out[rows[i]] = sum_k
    w[i, k] * x[slots[i, k]]``, one row reduction over the table (its order
    fixed by the table's shape, the same on every call):
    ``slots [n_rows, width]`` int32 positions into ``x`` (padding points at
    position ``n_in``, a zero appended to ``x``), ``weights`` of the same
    shape or None (all ones), ``rows`` the output index of each row, or
    None when row ``i`` is output ``i`` (then ``n_rows == n_out``)."""

    slots: torch.Tensor
    weights: torch.Tensor | None
    rows: torch.Tensor | None
    n_in: int
    n_out: int

    def sums(self, x: torch.Tensor) -> torch.Tensor:
        """The row sums ``[n_rows]`` of ``x`` (flat, ``n_in`` entries)."""
        if x.numel() != self.n_in:
            raise ValueError(f"sum plan over {self.n_in} entries, got {x.numel()}")
        xe = torch.cat([x.reshape(-1), x.new_zeros(1)])
        g = xe.index_select(0, self.slots.reshape(-1)).reshape(self.slots.shape)
        if self.weights is not None:
            g = g * self.weights
        return g.sum(dim=1)


def make_sum_plan(ids, n_out: int, weights=None, rows=None, src=None, n_in=None, dtype=torch.float64,
                  device="cuda") -> SumPlan:
    """The :class:`SumPlan` that adds entry ``j`` (times ``weights[j]``) of
    a flat input into output ``ids[j]``. ``src[j]`` is the input position of
    entry ``j`` in an input of ``n_in`` entries (default ``j`` and
    ``ids.size``: a scatter of the whole input); ``rows`` the
    outputs that get a row (default every output ``0..n_out-1``; each id
    must be one of them). Entries keep their input order within a row (a
    stable sort), as in the JAX package's sorted ``segment_sum``. Host numpy;
    the tables go to ``device``, the weights at ``dtype``."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    if src is None:
        src, n_in = np.arange(ids.size), ids.size
    else:
        src = np.asarray(src, dtype=np.int64).reshape(-1)
        if n_in is None or (src.size and int(src.max()) >= n_in):
            raise ValueError("make_sum_plan: src needs n_in above its largest position")
    if rows is None:
        row_of = ids
        n_rows = int(n_out)
    else:
        rows = np.asarray(rows, dtype=np.int64)
        lookup = np.full(int(n_out), -1, dtype=np.int64)
        lookup[rows] = np.arange(rows.size)
        row_of = lookup[ids]
        if (row_of < 0).any():
            raise ValueError("make_sum_plan: an id is not among the rows")
        n_rows = rows.size
    order = np.argsort(row_of, kind="stable")
    counts = np.bincount(row_of, minlength=n_rows)
    width = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    r = row_of[order]
    k = np.arange(order.size) - starts[r]
    slots = np.full((n_rows, width), n_in, dtype=np.int64)
    slots[r, k] = src[order]
    if n_in >= 2**31:
        raise ValueError("make_sum_plan: more than 2^31 input positions")
    w = None
    if weights is not None:
        wt = np.zeros((n_rows, width))
        wt[r, k] = np.asarray(weights, dtype=np.float64).reshape(-1)[order]
        w = torch.as_tensor(wt, dtype=dtype, device=device)
    return SumPlan(
        torch.as_tensor(slots.astype(np.int32), device=device),
        w,
        None if rows is None else torch.as_tensor(rows, device=device),
        int(n_in),
        int(n_out),
    )


def make_scatter_plan(elem_dof_map, n_dofs: int, device="cuda") -> SumPlan:
    """The scatter-add plan of a ``local_to_global`` table ``[E, (p+1)^3]``
    (JAX ``make_scatter_plan``: a stable sort of the flat map, here laid out
    as :class:`SumPlan` rows, one per DoF)."""
    flat = elem_dof_map.cpu().numpy() if isinstance(elem_dof_map, torch.Tensor) else np.asarray(elem_dof_map)
    return make_sum_plan(flat.reshape(-1), n_dofs, device=device)


def gather_indexed(u: torch.Tensor, elem_dof_map: torch.Tensor, p: int) -> torch.Tensor:
    """``read_dof_values`` via an explicit map: ``[n_dofs]`` -> ``[E, p+1,
    p+1, p+1]`` (local order z, y, x with x fastest, matching
    ``mesh.element_dof_map``)."""
    e = elem_dof_map.shape[0]
    return u.index_select(0, elem_dof_map.reshape(-1)).reshape(e, p + 1, p + 1, p + 1)


def scatter_indexed_sorted(v: torch.Tensor, plan: SumPlan, n_dofs: int) -> torch.Tensor:
    """``distribute_local_to_global`` through a :func:`make_scatter_plan`:
    the sum at each DoF in a fixed order, bitwise the same on every call."""
    if plan.n_out != n_dofs or plan.rows is not None:
        raise ValueError(f"not a scatter plan onto {n_dofs} DoFs")
    return plan.sums(v)


def scatter_indexed(v: torch.Tensor, elem_dof_map: torch.Tensor, n_dofs: int) -> torch.Tensor:
    """:func:`scatter_indexed_sorted` with a plan built for this call (host
    set-up work: callers that scatter more than once keep the plan)."""
    return scatter_indexed_sorted(v, make_scatter_plan(elem_dof_map, n_dofs, device=v.device), n_dofs)
