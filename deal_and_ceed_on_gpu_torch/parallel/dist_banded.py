"""Distributed K2: the banded Kronecker apply of BP1-BP4 on every rank's block.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/dist_banded.py``: every
rank runs K2 (``csrc/banded.cu``) in shard mode on its block, with the 1D
factors of its physical elements only (``ops/banded.banded_tables_np`` /
``element_tables_np`` with ``phys_elems``; dead elements have zero factors)
and Dirichlet rows and columns on its global walls only
(``BandedTables.ident``). Each Kronecker term is bilinear in its per-axis
factors and each element belongs to one rank, so the blocks' outputs hold
partial sums exactly on the shared planes, no input halo is needed, and one
plane exchange-and-add a partitioned axis (``dist_operator.halo_combine``,
z first) gives the global constrained ``M A M``. Uniform bricks; the x axis
is never partitioned. Vectors ``[nz, ny, nx]`` or ``[nc, nz, ny, nx]``
(BP2 / BP4: three components in one launch), at the compute dtype or, with
``stream_dtype=torch.bfloat16`` over float32, stored in bf16 as the
single-device ``banded`` backend streams them (K2 reads and writes bf16,
computes in f32; the shared planes' partials are summed in bf16).
"""

from __future__ import annotations

import torch

from ..basis import Basis1D
from ..ops.banded import BandedTables, banded_apply, banded_tables_np, element_tables_np
from ..ops.stencil import identity_mask
from .comm import ShardComm, rank_device
from .dist_operator import halo_combine
from .partition import BlockPartition

__all__ = ["DistBandedOperator"]


class DistBandedOperator:
    """A rank's K2 operator on its block of a ``pz x py`` partition.

    ``kind``: ``"stiffness"`` (BP3 / BP4) or ``"mass"`` (BP1 / BP2);
    ``value_const``: K2's constant value coefficient; ``n_q`` / ``rule``: the
    quadrature the 1D factors are assembled with (Gauss, q = p + 2 for the
    BPs). ``dtype``: the compute dtype; ``stream_dtype``: the vectors'
    (bfloat16 with float32). ``comm`` or (``coords``, ``device``) as for
    ``DistOperator``."""

    def __init__(
        self,
        part: BlockPartition,
        comm: ShardComm | None = None,
        dtype: torch.dtype = torch.float32,
        kind: str = "stiffness",
        value_const: float | None = None,
        n_q: int | None = None,
        rule: str = "gauss",
        stream_dtype: torch.dtype | None = None,
        coords: tuple[int, int, int] | None = None,
        device=None,
    ):
        if not part.mesh.is_uniform:
            raise ValueError("distributed banded kernel: uniform meshes only")
        if part.px > 1:
            raise ValueError("banded layout: the x axis is never partitioned; use a pz x py partition")
        self.part, self.comm, self.kind, self.dtype = part, comm, kind, dtype
        self.stream_dtype = dtype if stream_dtype is None else stream_dtype
        self.coords = comm.coords if comm is not None else tuple(coords or (0, 0, 0))
        self.device = rank_device(comm, device)
        iz, iy, _ = self.coords
        p = part.degree
        basis = Basis1D.make(p, p + 2 if n_q is None else n_q, rule)
        phys, faces = part.phys_elems(iz, iy), part.faces(iz, iy)
        self.tables = BandedTables.from_numpy(
            banded_tables_np(part.local_mesh, basis, kind, value_const, phys, faces), p, dtype, self.device,
            element=element_tables_np(part.local_mesh, basis, kind, value_const, phys), ident=part.ident(iz, iy),
        )
        self.ident_mask = identity_mask(self.tables.shape, self.tables.identity, self.device).contiguous()

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """The rank's block of ``A u`` at the stream dtype; every rank of the
        group calls it."""
        out = banded_apply(u.to(self.stream_dtype).contiguous(), self.tables)
        return halo_combine(out, self.comm, self.ident_mask)

    __call__ = vmult

    @property
    def dot_weight(self) -> torch.Tensor:
        return self.part.local_dot_weight(*self.coords, dtype=self.dtype, device=self.device)
