"""Block partitions of a brick over ranks.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/partition.py`` (the
reference's L0 distribution stack: p4est partitioning, owned and ghost DoF
index sets, ``bp5/step-64.cu:310,345-348``): the element grid is cut into
``pz x py [x px]`` blocks, one a rank. There are no index sets: the ghost
layer is the one nodal plane a block shares with its neighbour along each
partitioned axis.

Representation ("ghosted block"): every rank holds ``[nz_loc, ny_loc,
nx_loc]`` nodal planes; the last plane along each partitioned axis
duplicates the next block's first plane. Elementwise vector updates keep the
duplicates equal by construction, so only two operations communicate:

- ``vmult``: the partial sums on shared planes are added across one plane
  exchange a partitioned axis (``parallel/dist_operator.halo_combine``);
- dot products: duplicated planes are weighted out (``local_dot_weight``),
  then one all-reduce.

**Any shard count divides any mesh**: when ``m_d`` is not a multiple of the
axis's shard count the element grid is padded with dead elements past the
physical extent. Every nodal plane at or beyond the physical boundary plane
is constrained (the boundary is Dirichlet anyway, so the padding extends the
identity block): padded DoFs carry exact zeros through applies and CG
updates, and the padded solve equals the unpadded one on the physical DoFs
(``bp5/step-64.cu:704-708``'s any-rank-count property).

The host conversions are numpy; the per-rank masks and weights are torch
tensors for a rank's coordinates ``(iz, iy, ix)`` (JAX's ``axis_index``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh import BrickMesh

__all__ = ["BlockPartition", "SlabPartition"]


@dataclasses.dataclass(frozen=True)
class BlockPartition:
    """(z, y[, x]) block decomposition of a :class:`BrickMesh` over ``pz x py
    [x px]`` ranks (``py = px = 1``: z slabs). Rank order is z-major, x
    fastest: rank ``(iz * py + iy) * px + ix``."""

    mesh: BrickMesh
    degree: int
    pz: int
    py: int = 1
    px: int = 1

    def __post_init__(self):
        if self.pz < 1 or self.py < 1 or self.px < 1:
            raise ValueError("shard counts must be >= 1")

    # ------------------------------ sizes ----------------------------- #
    @property
    def n_shards(self) -> int:
        return self.pz * self.py * self.px

    @property
    def mz_local(self) -> int:
        return -(-self.mesh.n_elements[2] // self.pz)  # ceil

    @property
    def my_local(self) -> int:
        return -(-self.mesh.n_elements[1] // self.py)

    @property
    def mx_local(self) -> int:
        return -(-self.mesh.n_elements[0] // self.px)

    def coords(self, rank: int) -> tuple[int, int, int]:
        """``(iz, iy, ix)`` of a rank."""
        if not 0 <= rank < self.n_shards:
            raise ValueError(f"rank {rank} outside 0..{self.n_shards - 1}")
        iz, r = divmod(rank, self.py * self.px)
        iy, ix = divmod(r, self.px)
        return iz, iy, ix

    def rank(self, iz: int, iy: int, ix: int = 0) -> int:
        return (iz * self.py + iy) * self.px + ix

    @property
    def local_mesh(self) -> BrickMesh:
        """The per-rank element block. On a uniform global mesh its geometry
        is the same on every rank; on graded and mapped meshes it only fixes
        the structure (shapes, code paths), and its geometry values are
        placeholders that the rank's sliced global tables replace
        (``DistOperator``)."""
        mx, my, mz = self.mesh.n_elements
        lo = self.mesh.lower
        if self.mesh.is_uniform:
            hx, hy, hz = self.mesh.h
            return BrickMesh(
                (self.mx_local, self.my_local, self.mz_local),
                lo,
                (lo[0] + hx * self.mx_local, lo[1] + hy * self.my_local, lo[2] + hz * self.mz_local),
            )
        # a structural placeholder: rank 0's block of the global mesh,
        # padded with unit widths where rank 0 is smaller than the block
        hs = [
            np.pad(np.asarray(h)[:m], (0, m - min(m, np.asarray(h).size)), constant_values=1.0)
            for h, m in zip(self.mesh.h_axes(), (self.mx_local, self.my_local, self.mz_local))
        ]
        local = BrickMesh(
            (self.mx_local, self.my_local, self.mz_local),
            lo,
            tuple(lo[d] + float(hs[d].sum()) for d in range(3)),
            widths=tuple(hs) if self.mesh.widths is not None else None,
        )
        if self.mesh.is_mapped:
            local = local.deform(self.mesh.mapping, self.mesh.mapping_jacobian)
        return local

    @property
    def local_grid_shape(self) -> tuple[int, int, int]:
        p = self.degree
        return (self.mz_local * p + 1, self.my_local * p + 1, self.mx_local * p + 1)

    @property
    def global_grid_shape(self) -> tuple[int, int, int]:
        nx, ny, nz = self.mesh.n_nodes(self.degree)
        return (nz, ny, nx)

    @property
    def flat_grid_shape(self) -> tuple[int, int, int]:
        """The blocks concatenated (ghost and padding planes included) along
        every partitioned axis: the host layout of ``to_blocks``."""
        nzl, nyl, nxl = self.local_grid_shape
        return (self.pz * nzl, self.py * nyl, self.px * nxl)

    # ------------------------ per-rank geometry ----------------------- #
    def phys_elems(self, iz: int, iy: int, ix: int = 0) -> tuple[int, int, int]:
        """``(mx_p, my_p, mz_p)``: the physical elements of a rank's block
        (the rest are dead padding)."""
        mx, my, mz = self.mesh.n_elements
        return (
            int(np.clip(mx - ix * self.mx_local, 0, self.mx_local)),
            int(np.clip(my - iy * self.my_local, 0, self.my_local)),
            int(np.clip(mz - iz * self.mz_local, 0, self.mz_local)),
        )

    def faces(self, iz: int, iy: int) -> tuple[bool, bool, bool, bool]:
        """``(z_lo, z_hi, y_lo, y_hi)``: which faces of a rank's block are
        global walls (an upper face is one when the block reaches the global
        extent, dead padding included)."""
        mx, my, mz = self.mesh.n_elements
        return (iz == 0, (iz + 1) * self.mz_local >= mz, iy == 0, (iy + 1) * self.my_local >= my)

    def offsets(self, iz: int, iy: int, ix: int = 0) -> tuple[int, int, int]:
        """The global node index of a block's row 0, per axis (z, y, x)."""
        p = self.degree
        return (iz * self.mz_local * p, iy * self.my_local * p, ix * self.mx_local * p)

    def ident(self, iz: int, iy: int, ix: int = 0) -> tuple[int, ...]:
        """The identity rows of a rank's block, ``(zlo, zhi, ylo, yhi, xlo,
        xhi)``: row i of an axis is constrained when ``i < lo`` or ``i >=
        hi`` (global index 0, or at or beyond the last global plane)."""
        out = []
        for n, off, ng in zip(self.local_grid_shape, self.offsets(iz, iy, ix), self.global_grid_shape):
            out += [1 if off == 0 else 0, min(max(ng - 1 - off, 0), n)]
        return tuple(out)

    # ---------------------------------------------------------------- #
    # host-side conversions global grid <-> concatenated ghosted blocks
    # ---------------------------------------------------------------- #
    def to_blocks(self, u_global: np.ndarray) -> np.ndarray:
        """``[nz, ny, nx]`` global nodal grid -> ``flat_grid_shape`` array
        whose (iz, iy, ix) block holds that rank's ghosted local grid
        (padding beyond the physical extent is zero). A leading component
        axis passes through."""
        u_global = np.asarray(u_global)
        n_glob = int(np.prod(self.global_grid_shape))
        if u_global.ndim == 4 or (u_global.ndim == 2 and u_global.shape[1] == n_glob):
            comps = u_global.reshape(u_global.shape[0], *self.global_grid_shape)
            return np.stack([self.to_blocks(c) for c in comps])
        out = np.zeros(self.flat_grid_shape, dtype=u_global.dtype)
        for rank in range(self.n_shards):
            out[self._block_slices(rank)] = self.block(u_global, rank)
        return out

    def block(self, u_global: np.ndarray, rank: int) -> np.ndarray:
        """One rank's ghosted local grid ``local_grid_shape`` of a global
        grid (zero past the physical extent): what that rank holds."""
        u = np.asarray(u_global).reshape(self.global_grid_shape)
        out = np.zeros(self.local_grid_shape, dtype=u.dtype)
        src, n = [], []
        for off, nl, ng in zip(self.offsets(*self.coords(rank)), self.local_grid_shape, self.global_grid_shape):
            ln = max(0, min(nl, ng - off))
            src.append(slice(off, off + ln))
            n.append(slice(0, ln))
        out[tuple(n)] = u[tuple(src)]
        return out

    def _block_slices(self, rank: int) -> tuple[slice, slice, slice]:
        return tuple(
            slice(i * nl, (i + 1) * nl) for i, nl in zip(self.coords(rank), self.local_grid_shape)
        )

    def from_blocks(self, blocks: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`to_blocks` (drops duplicated ghost planes and
        dead padding); a leading component axis passes through."""
        blocks = np.asarray(blocks)
        if blocks.ndim == 4 and blocks.shape[1:] == self.flat_grid_shape:
            return np.stack([self.from_blocks(c) for c in blocks])
        b = blocks.reshape(self.flat_grid_shape)
        return self.assemble([b[self._block_slices(r)] for r in range(self.n_shards)])

    def assemble(self, local_blocks) -> np.ndarray:
        """The global grid from every rank's local grid (rank order): a rank
        owns its planes ``[offset, offset + block)`` clipped to the grid,
        the axis-final rank also the last plane."""
        nz, ny, nx = self.global_grid_shape
        first = np.asarray(local_blocks[0])
        out = np.zeros((nz, ny, nx), dtype=first.dtype)
        for rank, blk in enumerate(local_blocks):
            coords = self.coords(rank)
            dst, src = [], []
            for d, (i, pd, ng, nl) in enumerate(zip(coords, (self.pz, self.py, self.px), (nz, ny, nx),
                                                    self.local_grid_shape)):
                off = self.offsets(*coords)[d]
                step = nl - 1
                hi = ng if i == pd - 1 else min(off + step, ng)
                ln = max(0, hi - off)
                dst.append(slice(off, off + ln))
                src.append(slice(0, ln))
            if all(s.stop > s.start for s in src):
                out[tuple(dst)] = np.asarray(blk).reshape(self.local_grid_shape)[tuple(src)]
        return out

    def slice_table(self, table: np.ndarray) -> np.ndarray:
        """Slice a structured-layout table on the padded mesh (``[MZ_pad, q,
        MY_pad, q, MX_pad, q, ...]``, element-major) into the per-rank stack
        ``[n_shards, mz_loc, q, my_loc, q, mx_loc, q, ...]`` in rank order."""
        mzl, myl, mxl = self.mz_local, self.my_local, self.mx_local
        parts = []
        for rank in range(self.n_shards):
            iz, iy, ix = self.coords(rank)
            parts.append(table[iz * mzl:(iz + 1) * mzl, :, iy * myl:(iy + 1) * myl, :, ix * mxl:(ix + 1) * mxl])
        return np.stack(parts)

    # ---------------------------------------------------------------- #
    # per-rank masks and weights
    # ---------------------------------------------------------------- #
    def local_dirichlet_mask(self, iz: int, iy: int, ix: int = 0, device="cpu") -> torch.Tensor:
        """bool ``local_grid_shape``: planes at or beyond the physical
        boundary per axis (which subsumes the dead padding)."""
        ident = self.ident(iz, iy, ix)
        masks = []
        for d, n in enumerate(self.local_grid_shape):
            i = torch.arange(n, device=device)
            shape = [1, 1, 1]
            shape[d] = n
            masks.append(((i < ident[2 * d]) | (i >= ident[2 * d + 1])).reshape(shape))
        return masks[0] | masks[1] | masks[2]

    def local_dot_weight(self, iz: int, iy: int, ix: int = 0, dtype=torch.float64, device="cpu") -> torch.Tensor:
        """``[nz_loc, ny_loc, nx_loc or 1]`` weights: 0 on the ghost-duplicated
        planes (a rank's last plane along each partitioned axis, except on
        the axis-final rank). Padding DoFs are exactly zero and need no
        weight."""
        nzl, nyl, nxl = self.local_grid_shape
        wz = torch.ones(nzl, dtype=dtype, device=device)
        wy = torch.ones(nyl, dtype=dtype, device=device)
        if iz < self.pz - 1:
            wz[-1] = 0
        if iy < self.py - 1:
            wy[-1] = 0
        w = wz[:, None, None] * wy[None, :, None]
        if self.px > 1:
            wx = torch.ones(nxl, dtype=dtype, device=device)
            if ix < self.px - 1:
                wx[-1] = 0
            w = w * wx[None, None, :]
        return w

    # ----------------------- slab-compat aliases ---------------------- #
    def to_slabs(self, u_global: np.ndarray) -> np.ndarray:
        """z-slab view ``[n_shards, nz_loc, ny_loc, nx]`` (py == px == 1)."""
        return self.to_blocks(u_global).reshape(self.pz, *self.local_grid_shape)

    def from_slabs(self, slabs: np.ndarray) -> np.ndarray:
        return self.from_blocks(np.asarray(slabs).reshape(self.flat_grid_shape))


def SlabPartition(mesh: BrickMesh, degree: int, n_shards: int) -> BlockPartition:
    """Classic z-slab decomposition: ``BlockPartition`` with ``py = 1``."""
    return BlockPartition(mesh, degree, pz=n_shards)
