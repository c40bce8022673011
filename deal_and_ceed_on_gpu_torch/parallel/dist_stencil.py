"""Distributed K1: the collocated stencil on every rank's block, with its halo exchange.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/dist_pallas.py``
(``DistStencilOperator``): every rank runs K1 (``csrc/stencil.cu``) in
shard mode on its block with its own tables (``ops/stencil
.stencil_tables_np(phys_elems=, faces=)``):

- the band factors are assembled over the block's physical elements only,
  so rows on shared planes hold partial sums;
- the scalings ``s_d = sqrt(d_d)`` keep their partial weights on shared
  planes, and are zero on global walls and dead rows;
- K1 writes the identity rows only on the global walls and the dead rows
  (``StencilTables.ident``, the JAX epilogue's ``mz1 / my1 / mx1``).

The block's output then factorizes: summing the 2 (plane) or 4 (corner
line) sharers' values gives the global operator. Two schedules:

- ``overlap=False``: K1, then one plane exchange-and-add a partitioned axis
  (``dist_operator.halo_combine``, identity rows left as they are);
- ``overlap=True`` (default): the shared planes' partials first, by K1 on
  the (p+1)-plane slab next to each (``ops/stencil.plane_partial``: raw, at
  the compute dtype), their exchange issued, the full K1 launched while it
  is in flight, then the shared planes replaced by position-ordered sums
  (``dist_operator.overlap_exchange``, the 4-quadrant corner lines
  included) and their identity rows restored. With bf16 vectors the
  partials and their sums are f32 and rounded once (``dist_pallas.py:297-301``).

The port works on the unpadded local grid ``[nz_loc, ny_loc, nx]``, not the
TPU layout's padded rows: row 0 and row ``n - 1`` of each axis are the
shared planes. The x axis is never partitioned. The value term (collocated
Helmholtz, ``operator="helmholtz"``) is the rank's block of the global nodal
``a(x) hx hy hz``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..basis import Basis1D
from ..ops.stencil import StencilTables, identity_mask, plane_partial, stencil_apply, stencil_tables_np
from .comm import ShardComm, rank_device
from .dist_operator import halo_combine, overlap_exchange
from .partition import BlockPartition

__all__ = ["DistStencilOperator"]


class DistStencilOperator:
    """A rank's K1 operator on its block of a ``pz x py`` partition.

    ``operator``: ``"poisson"`` (BP5) or ``"helmholtz"`` (the collocated
    value term ``a(x)``, by default the step-64 coefficient). ``dtype``: the
    compute dtype; ``stream_dtype``: the vectors' (bfloat16 with float32).
    ``comm`` or (``coords``, ``device``) as for ``DistOperator``."""

    def __init__(
        self,
        part: BlockPartition,
        comm: ShardComm | None = None,
        dtype: torch.dtype = torch.float32,
        operator: str = "poisson",
        coefficient_fn=None,
        stream_dtype: torch.dtype | None = None,
        overlap: bool = True,
        coords: tuple[int, int, int] | None = None,
        device=None,
    ):
        if not part.mesh.is_uniform:
            raise ValueError("stencil kernel: uniform meshes only")
        if part.px > 1:
            raise ValueError("stencil layout: the x axis is never partitioned; use a pz x py partition")
        if operator not in ("poisson", "helmholtz"):
            raise ValueError(f"unknown stencil operator {operator!r}")
        self.part, self.comm, self.overlap, self.dtype = part, comm, overlap, dtype
        self.stream_dtype = dtype if stream_dtype is None else stream_dtype
        self.coords = comm.coords if comm is not None else tuple(coords or (0, 0, 0))
        self.device = rank_device(comm, device)
        iz, iy, _ = self.coords
        p = part.degree
        basis = Basis1D.make(p)
        tabs = stencil_tables_np(part.local_mesh, basis, part.phys_elems(iz, iy), part.faces(iz, iy))
        if operator == "helmholtz":
            tabs["a"] = self._value_block(basis, coefficient_fn)
        self.tables = StencilTables.from_numpy(tabs, p, dtype, self.device, ident=part.ident(iz, iy))
        self.ident_mask = identity_mask(self.tables.shape, self.tables.identity, self.device).contiguous()

    def _value_block(self, basis, coefficient_fn) -> np.ndarray:
        """The rank's block of ``a(x) hx hy hz`` on the global node grid
        (K1's ``S^2`` is the unit-cell weight product)."""
        from ..models.helmholtz import default_coefficient

        part = self.part
        fn = default_coefficient if coefficient_fn is None else coefficient_fn
        cx, cy, cz = part.mesh.node_coords_1d(part.degree, basis.nodes)
        X = np.stack(np.broadcast_arrays(cx[None, None, :], cy[None, :, None], cz[:, None, None]), axis=-1)
        hx, hy, hz = part.mesh.h
        a = np.asarray(fn(X), dtype=np.float64) * (hx * hy * hz)
        return part.block(a, part.rank(*self.coords))

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """The rank's block of ``A u`` at the stream dtype; every rank of the
        group calls it."""
        part, T = self.part, self.tables
        u = u.to(self.stream_dtype)
        overlap = self.overlap and self.comm is not None and (part.pz > 1 or part.py > 1)
        if overlap:
            zf, zl = (plane_partial(u, T, 0, 0), plane_partial(u, T, 0, -1)) if part.pz > 1 else (None, None)
            yf, yl = (plane_partial(u, T, 1, 0), plane_partial(u, T, 1, -1)) if part.py > 1 else (None, None)
            finish = overlap_exchange(self.comm, zf, zl, yf, yl)
        out = stencil_apply(u, T)  # needs none of the received planes
        if not overlap:
            return halo_combine(out, self.comm, self.ident_mask)
        for idx, val in finish():
            # the sums are 0 on identity rows (raw partials): u there
            out[idx] = torch.where(self.ident_mask[idx], u[idx], val.to(out.dtype))
        return out

    __call__ = vmult

    @property
    def dot_weight(self) -> torch.Tensor:
        """The rank's dot weights at the compute dtype (0 on the planes it
        duplicates)."""
        return self.part.local_dot_weight(*self.coords, dtype=self.dtype, device=self.device)

    def fold_scale(self, s: float) -> None:
        """``A <- s A`` on the unconstrained rows: K1's tables, in place."""
        self.tables.scale_(s)
