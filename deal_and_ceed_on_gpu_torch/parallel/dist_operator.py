"""Distributed matrix-free operators: the local cell loop and the halo exchange.

Counterpart of ``deal_and_ceed_on_gpu_tpu/parallel/dist_operator.py``. A
rank's apply is

    mask constrained -> local cell loop -> one plane exchange a partitioned
        axis, partial sums added -> Dirichlet identity rows

the reference's ``cell_loop`` with its ghost exchange (``compress(add)`` and
``update_ghost_values``, ``bp5/step-64.cu:241``). :class:`DistOperator`
wraps any :class:`~..models.operator_base.MatrixFreeOperator` (Poisson,
Helmholtz, mass, the vector BPs) on the ``separable``, ``structured``,
``gather`` and ``general`` (K4) backends; tables that depend on the block's
position (Helmholtz's ``a(x)``, graded and mapped geometry) are built on
the global mesh and sliced for the rank (``shard_table_names``).

The overlapped schedule (``separable``, and ``dist_stencil`` on K1): the
shared-plane partials a rank must send are computed first by restricted
plane applies, their exchange is issued, the full local apply runs while it
is in flight, and the shared planes are then replaced by position-ordered
sums, the corner lines of a 2D partition by the 4-quadrant sum
(``overlap_exchange``). Every sharer adds the same bits in the same order,
so duplicated planes stay bitwise equal.
"""

from __future__ import annotations

from typing import Type

import torch

from ..fe_space import FESpace
from ..models.operator_base import MatrixFreeOperator
from ..models.poisson import PoissonOperator
from .comm import ShardComm, rank_device
from .partition import BlockPartition

__all__ = ["DistOperator", "DistPoissonOperator", "halo_combine", "overlap_exchange"]


def halo_combine(dst: torch.Tensor, comm: ShardComm | None, ident: torch.Tensor | None = None) -> torch.Tensor:
    """Add the neighbours' partial sums on the shared planes of ``dst`` (a
    rank's block, ``[nz, ny, nx]`` or ``[nc, nz, ny, nx]``), in place: one
    plane exchange a partitioned axis, z first, then y, then x, so that the
    later exchanges carry the earlier pair sums across shared edges and
    corners. ``ident``: a bool mask of identity rows (``dst`` holds ``u``
    there, as K1 and K2 write it), left as they are."""
    if comm is None:
        return dst
    part = comm.part
    lead = dst.dim() - 3
    for axis, n in enumerate((part.pz, part.py, part.px)):
        if n == 1:
            continue
        d = lead + axis
        from_prev, from_next = comm.exchange(axis, dst.select(d, 0), dst.select(d, -1))
        for idx, recv in ((0, from_prev), (-1, from_next)):
            if recv is None:
                continue
            plane = dst.select(d, idx)
            if ident is None:
                plane.add_(recv)
            else:
                plane.copy_(torch.where(ident.expand(dst.shape).select(d, idx), plane, plane + recv))
    return dst


def overlap_exchange(comm: ShardComm, zf=None, zl=None, yf=None, yl=None):
    """Issue the overlapped halo exchange of a rank's plane partials (its
    first and last z planes ``zf``, ``zl`` ``[ny, nx]`` and y planes ``yf``,
    ``yl`` ``[nz, nx]``; None on an axis that is not partitioned) and return
    ``finish()``, which waits and returns the shared values as ``(index,
    value)`` pairs to assign: planes by ``from_prev + first`` and ``last +
    from_next``, then, on a 2D partition, the corner lines shared by four
    ranks by ``(a + b) + (c + d)`` of the four quadrants' z-plane partials
    in position order (JAX ``dist_operator.py:201-282``): the y neighbours'
    lines arrive by one y exchange, the diagonal neighbours' by a second
    hop along z. Every rank of the group calls it."""
    pend = {}
    if zf is not None:
        pend["z"] = comm.exchange(0, zf, zl, async_op=True)
    if yf is not None:
        pend["y"] = comm.exchange(1, yf, yl, async_op=True)
    corner = zf is not None and yf is not None
    if corner:
        pend["yl"] = comm.exchange(1, torch.stack([zf[0], zl[0]]), torch.stack([zf[-1], zl[-1]]), async_op=True)

    def finish():
        sets = []
        fpz, fnz = pend["z"].wait() if "z" in pend else (None, None)
        fpy, fny = pend["y"].wait() if "y" in pend else (None, None)
        if fpz is not None:
            sets.append(((0,), fpz + zf))
        if fnz is not None:
            sets.append(((-1,), zl + fnz))
        if fpy is not None:
            sets.append(((slice(None), 0), fpy + yf))
        if fny is not None:
            sets.append(((slice(None), -1), yl + fny))
        if corner:
            # pyl: (iz, iy-1)'s [first, last] z partials on its upper y line;
            # nyl: (iz, iy+1)'s on its lower y line (zero where absent)
            pyl, nyl = pend["yl"].wait()
            zero = torch.zeros_like(torch.stack([zf[0], zl[0]]))
            pyl = zero if pyl is None else pyl
            nyl = zero if nyl is None else nyl
            # second hop: from (iz-1, iy) its [pyl[1], nyl[1]] = (iz-1, iy-1)'s
            # and (iz-1, iy+1)'s last-plane lines; from (iz+1, iy) the first-plane ones
            dp, dn = comm.exchange(0, torch.stack([pyl[0], nyl[0]]), torch.stack([pyl[1], nyl[1]]))
            if fpz is not None and fpy is not None:
                sets.append(((0, 0), (dp[0] + fpz[0]) + (pyl[0] + zf[0])))
            if fpz is not None and fny is not None:
                sets.append(((0, -1), (fpz[-1] + dp[1]) + (zf[-1] + nyl[0])))
            if fnz is not None and fpy is not None:
                sets.append(((-1, 0), (pyl[1] + zl[0]) + (dn[0] + fnz[0])))
            if fnz is not None and fny is not None:
                sets.append(((-1, -1), (zl[-1] + nyl[1]) + (fnz[-1] + dn[1])))
        return sets

    return finish


class DistOperator:
    """A rank's matrix-free operator on its block of a :class:`BlockPartition`.

    ``comm``: the rank's :class:`ShardComm` (its coordinates and device), or
    None with ``coords`` and ``device`` for an apply without exchange (one
    rank's partial sums; ``device`` defaults to ``cuda`` and raises without
    a card). The other parameters are those of the local
    operator: ``op_cls(space, backend=..., **op_kwargs)`` on the block's
    ``FESpace`` (``rule``, ``n_q``, ``dtype``). Vectors are the rank's ghosted
    block ``local_grid_shape``, or ``[nc, ...]`` for nc components that share
    the tables (the vector BPs)."""

    BACKENDS = ("separable", "structured", "gather", "general")

    def __init__(
        self,
        part: BlockPartition,
        comm: ShardComm | None = None,
        op_cls: Type[MatrixFreeOperator] = PoissonOperator,
        dtype: torch.dtype = torch.float32,
        backend: str = "separable",
        rule: str = "gauss_lobatto",
        n_q: int | None = None,
        coords: tuple[int, int, int] | None = None,
        device=None,
        **op_kwargs,
    ):
        if backend not in self.BACKENDS:
            raise ValueError(
                f"distributed backend {backend!r} unsupported: the rank's apply must be a cell loop "
                f"({', '.join(self.BACKENDS)}); K1 and K2 have their own (parallel/dist_stencil.py, dist_banded.py)"
            )
        if backend == "general" and not part.mesh.is_uniform:
            # K4 streams per-element tables in its own [K, E, Q] layout whose
            # slicing per rank is not wired (as in JAX dist_operator.py:99-108)
            raise ValueError("distributed general (K4) supports uniform global meshes; use backend='structured' "
                             "for graded and mapped meshes")
        self.part, self.comm, self.backend = part, comm, backend
        self.coords = comm.coords if comm is not None else tuple(coords or (0, 0, 0))
        device = rank_device(comm, device)
        self.space = FESpace.create(part.local_mesh, part.degree, n_q=n_q, rule=rule, dtype=dtype, device=device)
        # the local operator has no constraint handling: the masks are the rank's
        op = op_cls(self.space, backend=backend, **op_kwargs)
        if op._dist_unsupported:
            raise ValueError(f"{op_cls.__name__}: {op._dist_unsupported}")
        names = op.shard_table_names()
        if not part.mesh.is_uniform and not names:
            raise ValueError(f"{op_cls.__name__}: graded and mapped global meshes need position-dependent tables "
                             "(shard_table_names); use backend='structured'")
        if names:
            if backend != "structured":
                raise ValueError(f"{op_cls.__name__} has position-dependent tables; use backend='structured'")
            op = op.bind_shard_tables(self._rank_tables(op_cls, names, n_q, rule, dtype, device, op_kwargs))
        self._op = op
        self.mask = part.local_dirichlet_mask(*self.coords, device=device)

    def _rank_tables(self, op_cls, names, n_q, rule, dtype, device, op_kwargs) -> dict:
        """The position-dependent tables of this rank: built on the physical
        global mesh (on the host), zero over the dead elements (which then
        add nothing), sliced to the rank's block."""
        import numpy as np

        part = self.part
        gspace = FESpace.create(part.mesh, part.degree, n_q=n_q, rule=rule, dtype=torch.float64, device="cpu")
        gop = op_cls(gspace, backend="structured", **op_kwargs)
        mx, my, mz = part.mesh.n_elements
        pads = (part.mz_local * part.pz - mz, part.my_local * part.py - my, part.mx_local * part.px - mx)
        out = {}
        rank = part.rank(*self.coords)
        for name in names:
            t = getattr(gop, name).numpy()
            pad = [(0, 0)] * t.ndim
            pad[0], pad[2], pad[4] = (0, pads[0]), (0, pads[1]), (0, pads[2])  # [MZ, q, MY, q, MX, q, ...]
            sliced = part.slice_table(np.pad(t, pad))[rank]
            out[name] = torch.as_tensor(sliced, dtype=dtype, device=device)
        return out

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """The rank's block of ``A u``; every rank of the group calls it."""
        if u.dim() == 4:
            # the components share the tables (BP2 / BP4 / BP6)
            return torch.stack([self.vmult(c) for c in u])
        part = self.part
        us = torch.where(self.mask, torch.zeros((), dtype=u.dtype, device=u.device), u)
        op = self._op
        if op._sep_terms is not None and self.comm is not None and (part.pz > 1 or part.py > 1) and part.px == 1:
            dst = self._vmult_overlap(us, op)
        else:
            dst = op.apply_cell_loop(us.reshape(-1)).reshape(u.shape)
            dst = halo_combine(dst, self.comm)
        return torch.where(self.mask, u, dst)

    __call__ = vmult

    def _vmult_overlap(self, us: torch.Tensor, op) -> torch.Tensor:
        """The overlapped apply (``separable``): the plane partials, their
        exchange in flight during the full apply, the shared values set."""
        from ..ops.separable import apply_separable, apply_separable_plane

        part = self.part
        terms, mode = op._sep_terms, op.sep_mode

        def plane(axis, side):
            return apply_separable_plane(us, terms, axis, side, mode).squeeze(axis)

        zf, zl = (plane(0, 0), plane(0, -1)) if part.pz > 1 else (None, None)
        yf, yl = (plane(1, 0), plane(1, -1)) if part.py > 1 else (None, None)
        finish = overlap_exchange(self.comm, zf, zl, yf, yl)
        dst = apply_separable(us, terms, mode)  # needs none of the received planes
        for idx, val in finish():
            dst[idx] = val
        return dst

    @property
    def dot_weight(self) -> torch.Tensor:
        """The rank's dot weights (0 on the planes it duplicates)."""
        return self.part.local_dot_weight(*self.coords, dtype=self.space.dtype, device=self.space.device)

    def fold_scale(self, s: float) -> None:
        """``A <- s A`` on the unconstrained rows (the chained-vmult mode)."""
        self._op.fold_scale(s)

    def jacobi_blocks(self, op_cls=None, **op_kwargs) -> torch.Tensor:
        """The rank's block of the global operator's true Jacobi
        preconditioner ``1 / diag(A)`` (built on the host from the global
        operator), identity on the padding rows."""
        import numpy as np

        basis = self.space.basis
        gspace = FESpace.create(self.part.mesh, self.part.degree, n_q=basis.n_q,
                                rule="gauss_lobatto" if basis.collocation else "gauss",
                                dtype=torch.float64, device="cpu")
        gop = (op_cls or type(self._op))(gspace, backend="structured", **op_kwargs)
        d = gop.jacobi_preconditioner().numpy().reshape(gspace.grid_shape)
        blk = self.part.block(d, self.part.rank(*self.coords))
        blk[blk == 0.0] = 1.0  # padding rows: identity
        return torch.as_tensor(np.ascontiguousarray(blk), dtype=self.space.dtype, device=self.space.device)


def DistPoissonOperator(part, comm=None, dtype=torch.float32, backend: str = "separable", **kw):
    """The BP5 Poisson distributed operator."""
    return DistOperator(part, comm, PoissonOperator, dtype=dtype, backend=backend, **kw)
