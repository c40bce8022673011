"""Solution output: VTK files (DataOut equivalent, reference L-18,
``step-64/step-64.cu:560-588``).

Counterpart of ``deal_and_ceed_on_gpu_tpu/utils/vtk.py``, writing the same
bytes for the same mesh, space and values:

- ``write_solution_vtr``: a rectilinear grid (``.vtr``) on the nodal grid of
  a brick, by the native writer (``utils/native.py``) or the pure-Python
  one, ``_write_vtr_py``; a mapped mesh goes to ``write_solution_vts``, a
  structured grid with the deformed point coordinates;
- ``write_solution_vtu``: an unstructured grid (``.vtu``) of an adaptive
  space, ``p^3`` linear sub-hexes per active cell, the values made
  conforming (``distribute``, on the host in the JAX package's order);
- ``write_solution_pvtr``: a distributed solution, one ``.vtr`` piece per
  block of a ``BlockPartition`` plus a ``.pvtr`` master.

The values may be tensors on any device, or numpy arrays: they are moved
to the host as float64.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from . import native

__all__ = [
    "write_solution_vtr",
    "write_solution_vts",
    "write_solution_vtu",
    "write_solution_pvtr",
]


def _host(a) -> np.ndarray:
    """float64 host copy of a tensor (any device, any float dtype) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def _appended(path, header: str, blobs) -> None:
    """Write ``header`` and the raw appended blobs, each after its UInt64
    byte count, then the closing tags."""
    with open(path, "wb") as f:
        f.write(header.encode())
        for b in blobs:
            f.write(struct.pack("<Q", len(b)))
            f.write(b)
        f.write(b"\n</AppendedData>\n</VTKFile>\n")


def _offsets(blobs) -> list[int]:
    offsets, off = [], 0
    for b in blobs:
        offsets.append(off)
        off += 8 + len(b)
    return offsets


def _vtr(path, xs, ys, zs, values, whole_ext, piece_ext, field_name) -> None:
    xs, ys, zs = (np.ascontiguousarray(a, np.float64) for a in (xs, ys, zs))
    values = np.ascontiguousarray(values, np.float64)
    blobs = [values.tobytes(), xs.tobytes(), ys.tobytes(), zs.tobytes()]
    offsets = _offsets(blobs)
    hdr = (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="RectilinearGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">\n'
        f'<RectilinearGrid WholeExtent="{whole_ext}">\n<Piece Extent="{piece_ext}">\n'
        f'<PointData Scalars="{field_name}">\n'
        f'<DataArray type="Float64" Name="{field_name}" format="appended" '
        f'offset="{offsets[0]}"/>\n</PointData>\n<Coordinates>\n'
        + "".join(
            f'<DataArray type="Float64" Name="{n}" format="appended" offset="{o}"/>\n'
            for n, o in zip("xyz", offsets[1:])
        )
        + "</Coordinates>\n</Piece>\n</RectilinearGrid>\n"
        '<AppendedData encoding="raw">\n_'
    )
    _appended(path, hdr, blobs)


def _write_vtr_py(path, xs, ys, zs, values, field_name="solution"):
    """The pure-Python ``.vtr`` writer: the native ``write_vtr``'s bytes."""
    nx, ny, nz = np.size(xs), np.size(ys), np.size(zs)
    ext = f"0 {nx-1} 0 {ny-1} 0 {nz-1}"
    _vtr(path, xs, ys, zs, values, ext, ext, field_name)


def _gll_nodes(p):
    from ..basis import Basis1D

    return Basis1D.make(p, rule="gauss_lobatto").nodes


def write_solution_pvtr(path, part, blocks, field_name="solution"):
    """Distributed solution output: one ``.vtr`` piece per block plus a
    ``.pvtr`` master record tying them together (the reference's
    per-rank-VTU + PVTU scheme, ``step-64/step-64.cu:560-588``).

    ``part``: the ``parallel.BlockPartition`` of the solve; ``blocks``: the
    blocks concatenated in ``part.flat_grid_shape`` (``part.to_blocks``'s
    layout; a tensor on any device or a numpy array). Pieces carry their
    global extents (shared boundary planes overlap by one node, as ParaView
    expects); dead padding is clipped off, and a block with no physical node
    writes no piece. Returns the master path; the pieces land next to it as
    ``<stem>_<k>.vtr``, k the block's rank."""
    blocks = _host(blocks).reshape(part.flat_grid_shape)
    nz, ny, nx = part.global_grid_shape
    nzl, nyl, nxl = part.local_grid_shape
    p = part.degree
    xs, ys, zs = part.mesh.node_coords_1d(p, _gll_nodes(p))
    whole = f"0 {nx-1} 0 {ny-1} 0 {nz-1}"
    stem, _ = os.path.splitext(path)
    pieces = []
    k = 0
    sz, sy, sx = part.mz_local * p, part.my_local * p, part.mx_local * p
    for iz in range(part.pz):
        z0, z1 = iz * sz, min(iz * sz + nzl - 1, nz - 1)
        for iy in range(part.py):
            y0, y1 = iy * sy, min(iy * sy + nyl - 1, ny - 1)
            for ix in range(part.px):
                x0, x1 = ix * sx, min(ix * sx + nxl - 1, nx - 1)
                if z1 < z0 or y1 < y0 or x1 < x0:
                    k += 1
                    continue  # a fully dead block: no physical nodes
                piece_ext = f"{x0} {x1} {y0} {y1} {z0} {z1}"
                vals = blocks[
                    iz * nzl : iz * nzl + (z1 - z0 + 1),
                    iy * nyl : iy * nyl + (y1 - y0 + 1),
                    ix * nxl : ix * nxl + (x1 - x0 + 1),
                ]
                ppath = f"{stem}_{k}.vtr"
                _vtr(ppath, xs[x0 : x1 + 1], ys[y0 : y1 + 1], zs[z0 : z1 + 1], vals, whole, piece_ext, field_name)
                pieces.append((piece_ext, os.path.basename(ppath)))
                k += 1
    master = (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="PRectilinearGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">\n'
        f'<PRectilinearGrid WholeExtent="{whole}" GhostLevel="0">\n'
        f'<PPointData Scalars="{field_name}">\n'
        f'<PDataArray type="Float64" Name="{field_name}"/>\n'
        "</PPointData>\n<PCoordinates>\n"
        '<PDataArray type="Float64" Name="x"/>\n'
        '<PDataArray type="Float64" Name="y"/>\n'
        '<PDataArray type="Float64" Name="z"/>\n'
        "</PCoordinates>\n"
        + "".join(f'<Piece Extent="{ext}" Source="{src}"/>\n' for ext, src in pieces)
        + "</PRectilinearGrid>\n</VTKFile>\n"
    )
    with open(path, "w") as f:
        f.write(master)
    return path


def write_solution_vtr(path, space, u, field_name="solution"):
    """Write the FE solution on its nodal grid to ``path`` (.vtr); mapped
    (deformed) meshes are sent to the curvilinear .vts writer."""
    if space.mesh.is_mapped:
        return write_solution_vts(path, space, u, field_name)
    xs, ys, zs = space.mesh.node_coords_1d(space.degree, space.basis.nodes)
    values = _host(u).reshape(space.grid_shape)
    if not native.write_vtr(path, xs, ys, zs, values, field_name):
        _write_vtr_py(path, xs, ys, zs, values, field_name)
    return path


def write_solution_vts(path, space, u, field_name="solution"):
    """VTK structured grid (.vts) with explicit point coordinates: the
    curvilinear output of mapped meshes (reference L-18 ``DataOut`` handles
    deformed mappings the same way)."""
    nz, ny, nx = space.grid_shape
    pts = space.node_coords().astype(np.float64)  # [n_dofs, 3], x fastest
    values = np.ascontiguousarray(_host(u).reshape(-1))
    blobs = [values.tobytes(), np.ascontiguousarray(pts).tobytes()]
    offsets = _offsets(blobs)
    ext = f"0 {nx-1} 0 {ny-1} 0 {nz-1}"
    hdr = (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="StructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">\n'
        f'<StructuredGrid WholeExtent="{ext}">\n<Piece Extent="{ext}">\n'
        f'<PointData Scalars="{field_name}">\n'
        f'<DataArray type="Float64" Name="{field_name}" format="appended" '
        f'offset="{offsets[0]}"/>\n</PointData>\n<Points>\n'
        f'<DataArray type="Float64" NumberOfComponents="3" '
        f'format="appended" offset="{offsets[1]}"/>\n'
        "</Points>\n</Piece>\n</StructuredGrid>\n"
        '<AppendedData encoding="raw">\n_'
    )
    _appended(path, hdr, blobs)
    return path


def _conforming(space, u) -> np.ndarray:
    """``space.distribute(u)`` on the host, float64: each hanging DoF the
    sum of its masters' weighted values, added in the order of the
    row-sorted constraint triplets at the space's dtype, as the JAX
    package's ``segment_sum`` adds them, so that the written bytes are that
    package's (the device's ``distribute`` adds the same terms in another
    order, an ulp apart at most)."""
    dt = torch.empty((), dtype=space.dtype).numpy().dtype
    values = (u.detach().cpu().numpy() if isinstance(u, torch.Tensor) else np.asarray(u)).astype(dt).reshape(-1)
    rows, cols, w = space._hang_np
    if rows.size:
        sums = np.zeros_like(values)
        np.add.at(sums, rows, w.astype(dt) * values[cols])
        hanging = space.hanging_mask_np
        values = values.copy()
        values[hanging] = sums[hanging]
    return values.astype(np.float64)


def write_solution_vtu(path, space, u, field_name="solution"):
    """VTK unstructured grid (.vtu) for adaptive (hanging-node) spaces:
    every active cell is written as p^3 linear sub-hexes over its nodal
    lattice (deal.II ``DataOut`` with ``n_subdivisions = p``, the
    reference's VTU output, ``step-64/step-64.cu:560-588``). Nodal values
    are written conforming (``space.distribute``, on the host:
    ``_conforming``), so hanging nodes carry their interpolated values."""
    p = space.degree
    p1 = p + 1
    pts = np.ascontiguousarray(space.node_coords, dtype=np.float64)
    values = np.ascontiguousarray(_conforming(space, u))
    dof_map = space._dof_map_np  # [E, p1^3], local (k, j, i) = (z, y, x)

    # sub-hex corner offsets in VTK_HEXAHEDRON order (bottom CCW, top CCW)
    corners = np.array(
        [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
         (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    )  # (di, dj, dk)
    k, j, i = np.meshgrid(np.arange(p), np.arange(p), np.arange(p), indexing="ij")
    base = np.stack([i, j, k], axis=-1).reshape(-1, 3)  # [p^3, 3] (i, j, k)
    loc = (
        (base[:, None, 2] + corners[None, :, 2]) * p1
        + (base[:, None, 1] + corners[None, :, 1])
    ) * p1 + (base[:, None, 0] + corners[None, :, 0])  # [p^3, 8]
    conn = dof_map[:, loc].reshape(-1, 8).astype(np.int64)  # [E p^3, 8]
    n_cells = conn.shape[0]
    offsets = np.arange(1, n_cells + 1, dtype=np.int64) * 8
    types = np.full(n_cells, 12, dtype=np.uint8)  # VTK_HEXAHEDRON

    blobs = [
        values.tobytes(),
        pts.tobytes(),
        np.ascontiguousarray(conn).tobytes(),
        offsets.tobytes(),
        types.tobytes(),
    ]
    offs = _offsets(blobs)
    hdr = (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">\n'
        "<UnstructuredGrid>\n"
        f'<Piece NumberOfPoints="{pts.shape[0]}" NumberOfCells="{n_cells}">\n'
        f'<PointData Scalars="{field_name}">\n'
        f'<DataArray type="Float64" Name="{field_name}" format="appended" '
        f'offset="{offs[0]}"/>\n</PointData>\n<Points>\n'
        f'<DataArray type="Float64" NumberOfComponents="3" '
        f'format="appended" offset="{offs[1]}"/>\n</Points>\n<Cells>\n'
        f'<DataArray type="Int64" Name="connectivity" format="appended" '
        f'offset="{offs[2]}"/>\n'
        f'<DataArray type="Int64" Name="offsets" format="appended" '
        f'offset="{offs[3]}"/>\n'
        f'<DataArray type="UInt8" Name="types" format="appended" '
        f'offset="{offs[4]}"/>\n'
        "</Cells>\n</Piece>\n</UnstructuredGrid>\n"
        '<AppendedData encoding="raw">\n_'
    )
    _appended(path, hdr, blobs)
    return path
