"""Ranks, neighbours and the two collectives of the distributed port.

The counterpart of ``shard_map``'s ``ppermute`` and ``psum`` in the JAX
package (``parallel/dist_operator.py``, ``solvers/cg.py:49-56``), and of the
reference's MPI transport (``tests/cuda_aware_mpi.cc``): ranks are
processes of a ``torch.distributed`` process group, one block of a
:class:`~.partition.BlockPartition` each. :class:`ShardComm` knows this
rank's block coordinates ``(iz, iy, ix)`` and its neighbours along each
axis, and does

- ``exchange(axis, lo_plane, hi_plane)``: send the lower plane to the
  previous rank and the upper one to the next, receive theirs; returns
  ``(from_prev, from_next)`` (None where there is no neighbour), or a
  pending handle with ``async_op=True`` (issued before a kernel launch,
  waited after it);
- ``allreduce_sum_(t)``: the all-reduce of a small tensor of scalars (or
  of the adaptive operator's shared-surface buffer);
- ``all_gather(t)``: every rank's copy of a small tensor (the multigrid
  coarse solves);
- ``all_to_all(axis, chunks)``: the exchange of one chunk with every rank
  of this rank's *line* along ``axis`` (the ranks that share the other
  block coordinates; the distributed FDM's transposes), by point-to-point
  messages within the group.

:class:`SlabComm` is the 1-D communicator of the adaptive partition
(``parallel/dist_adaptive.py``): a rank's slab index and the all-reduce and
all-gather above, no neighbours.

Backends, named by the caller and never switched:

- ``nccl``: one card a rank; point-to-point and all-reduce on CUDA tensors
  (``batch_isend_irecv`` on NCCL's own stream). NCCL refuses two ranks on
  one card, so more ranks than cards raise here;
- ``gloo``: any number of ranks, on the CPU or sharing a card. Gloo has no
  point-to-point for CUDA tensors: the halo planes of CUDA tensors go
  through pinned host buffers (a device-to-host copy before the send, a
  host-to-device copy after the receive). Its all-reduce of CUDA tensors
  exists (it copies through the host itself) and is used as it is; the
  all-gather and the all-to-all chunks go through pinned host buffers as
  the planes do. The choice follows the backend and the tensor's device,
  never a failure.

``init_shards(pz, py, px, backend, device)`` joins the group of a
``torchrun`` launch (``env://``); ``spawn(fn, n, ...)`` starts ``n`` ranks
as processes with a ``FileStore`` rendezvous in a temporary directory (the
driver and the tests) and returns what each rank's ``fn`` returned.
"""

from __future__ import annotations

import datetime
import itertools
import os
import tempfile
import traceback

import torch
import torch.distributed as dist

from ..fe_space import resolve_device
from .partition import BlockPartition

__all__ = ["ShardComm", "SlabComm", "init_shards", "rank_device", "spawn", "BACKENDS"]

BACKENDS = ("nccl", "gloo")


def _check_backend(backend: str, n_ranks: int, device: torch.device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices (use gloo on the CPU)")
        n_cards = torch.cuda.device_count()
        if n_ranks > n_cards:
            raise ValueError(
                f"nccl needs one card a rank: {n_ranks} ranks, {n_cards} card(s) (NCCL refuses two ranks on one "
                "card); run more ranks on one card with --dist-backend gloo"
            )


class _Pending:
    """An exchange in flight: ``wait()`` returns ``(from_prev, from_next)``."""

    def __init__(self, works, recv, finish):
        self._works, self._recv, self._finish = works, recv, finish

    def wait(self):
        for w in self._works:
            w.wait()
        return self._finish(self._recv)


class _Collectives:
    """The collectives every communicator of the port has: the all-reduce
    and the all-gather over ``group``, with gloo's CUDA tensors staged
    through pinned host buffers."""

    def _setup(self, device, group, n_ranks: int):
        self.group = group
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        if dist.get_world_size(group) != n_ranks:
            raise ValueError(f"the group has {dist.get_world_size(group)} ranks, the partition {n_ranks}")
        self.rank = dist.get_rank(group)
        self._tags = itertools.count()  # exchange sequence numbers: message tags
        self._pinned = {}

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _host(self, t: torch.Tensor, slot) -> torch.Tensor:
        """A pinned host buffer of ``t``'s shape and dtype (cached per slot)."""
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` travels through host buffers (gloo and a CUDA tensor)."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def allreduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; every rank gets the same
        bits."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[n_ranks, *t.shape]``: every rank's ``t`` in group rank order,
        on every rank (the same bits everywhere)."""
        t = t.contiguous()
        n = dist.get_world_size(self.group)
        if self._staged(t):
            src = self._host(t, "gather-in")
            src.copy_(t)
            outs = [self._host(t, ("gather-out", k)) for k in range(n)]
            dist.all_gather(outs, src, group=self.group)
            return torch.stack(outs).to(t.device)
        outs = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(outs, t, group=self.group)
        return torch.stack(outs)

    def gather_object(self, obj):
        """Every rank's picklable ``obj`` on group rank 0 (rank order),
        None on the others."""
        n = dist.get_world_size(self.group)
        objs = [None] * n if self.rank == 0 else None
        dist.gather_object(obj, objs, dst=self._global(0), group=self.group)
        return objs


class ShardComm(_Collectives):
    """This rank's place in a partition and its collectives.

    ``group``: the process group (None: the default group); ranks of the
    partition are the group's ranks in partition order. ``device``: where
    this rank's tensors live. ``backend``: the group's backend (its name
    decides how CUDA tensors travel)."""

    def __init__(self, part: BlockPartition, device, group=None):
        self.part = part
        self._setup(device, group, part.n_shards)
        self.coords = part.coords(self.rank)

    def with_partition(self, part: BlockPartition) -> "ShardComm":
        """This rank's comm on another partition of the same ``pz x py x
        px`` layout (a multigrid level): the same group, message tags and
        host buffers."""
        if (part.pz, part.py, part.px) != (self.part.pz, self.part.py, self.part.px):
            raise ValueError("with_partition: the partition's layout differs from this comm's")
        c = ShardComm.__new__(ShardComm)
        c.__dict__.update(self.__dict__)
        c.part = part
        return c

    # ------------------------------------------------------------------ #
    def neighbours(self, axis: int) -> tuple[int | None, int | None]:
        """Group ranks of the previous and next block along ``axis`` (0 = z,
        1 = y, 2 = x), None at the ends."""
        n = (self.part.pz, self.part.py, self.part.px)[axis]
        c = list(self.coords)
        out = []
        for step in (-1, 1):
            if 0 <= c[axis] + step < n:
                d = list(c)
                d[axis] += step
                out.append(self.part.rank(*d))
            else:
                out.append(None)
        return out[0], out[1]

    def exchange(self, axis: int, lo_plane: torch.Tensor, hi_plane: torch.Tensor, async_op: bool = False):
        """Send ``lo_plane`` to the previous rank along ``axis`` and
        ``hi_plane`` to the next; receive the previous rank's upper plane
        and the next rank's lower one: ``(from_prev, from_next)``, None
        where there is no neighbour. Every rank of the group calls it, in
        the same order."""
        prev, nxt = self.neighbours(axis)
        seq = next(self._tags)
        staged = self._staged(lo_plane)
        sends, recvs = [], {}
        for peer, plane, side, tag in ((prev, lo_plane, "prev", 2 * seq), (nxt, hi_plane, "next", 2 * seq + 1)):
            if peer is None:
                continue
            plane = plane.contiguous()
            if staged:
                # blocking copies: a pinned buffer is free again when its copy returns
                buf = self._host(plane, ("send", side, seq % 8))
                buf.copy_(plane)
                plane = buf
                recv = self._host(plane, ("recv", side, seq % 8))
            else:
                recv = torch.empty_like(plane)
            # a message to the previous rank carries tag 2 seq, to the next 2 seq + 1;
            # the previous rank's to us was sent to its next: tag 2 seq + 1
            sends.append((peer, plane, tag))
            recvs[side] = (peer, recv, 2 * seq + (1 if side == "prev" else 0))
        works = self._p2p(sends, list(recvs.values()))

        def finish(rv):
            out = []
            for side in ("prev", "next"):
                if side not in rv:
                    out.append(None)
                    continue
                t = rv[side][1]
                out.append(t.to(lo_plane.device) if staged else t)
            return tuple(out)

        pending = _Pending(works, recvs, finish)
        return pending if async_op else pending.wait()

    def _p2p(self, sends, recvs):
        if not sends and not recvs:
            return []
        if self.backend == "nccl":
            ops = [dist.P2POp(dist.isend, t, self._global(peer), self.group) for peer, t, _ in sends]
            ops += [dist.P2POp(dist.irecv, t, self._global(peer), self.group) for peer, t, _ in recvs]
            return dist.batch_isend_irecv(ops)
        works = [dist.isend(t, self._global(peer), group=self.group, tag=tag) for peer, t, tag in sends]
        works += [dist.irecv(t, self._global(peer), group=self.group, tag=tag) for peer, t, tag in recvs]
        return works

    def shared_planes_equal(self, x: torch.Tensor) -> bool:
        """Whether every plane of ``x`` (a rank's block) that two ranks share
        holds the same bits on both; the same answer on every rank."""
        ok = True
        lead = x.dim() - 3
        for axis, n in enumerate((self.part.pz, self.part.py, self.part.px)):
            if n == 1:
                continue
            d = lead + axis
            _, from_next = self.exchange(axis, x.select(d, 0), x.select(d, -1))
            if from_next is not None:
                ok &= bool(torch.equal(x.select(d, -1), from_next))
        bad = torch.tensor([0.0 if ok else 1.0], dtype=torch.float64, device=x.device)
        return float(self.allreduce_sum_(bad)[0]) == 0.0

    def gather_blocks(self, x: torch.Tensor):
        """Every rank's block of ``x`` as numpy arrays on group rank 0 (rank
        order), None on the others."""
        return self.gather_object(x.cpu().numpy())

    # ------------------------------------------------------------------ #
    def line(self, axis: int) -> list[int]:
        """The group ranks of this rank's line along ``axis`` (0 = z: the
        ranks of this ``(iy, ix)``; 1 = y: of this ``(iz, ix)``; 2 = x), in
        the order of the axis coordinate."""
        n = (self.part.pz, self.part.py, self.part.px)[axis]
        out = []
        for k in range(n):
            c = list(self.coords)
            c[axis] = k
            out.append(self.part.rank(*c))
        return out

    def all_to_all(self, axis: int, chunks):
        """Send ``chunks[k]`` to the k-th rank of this rank's line along
        ``axis`` and return what each sent here, in line order (a list;
        ``chunks`` itself on an axis that is not partitioned). A chunk that
        comes back has the shape of the one sent to its sender. Every rank
        of the group calls it at the same point of its program. The line's
        ranks trade their chunks by point-to-point messages in the comm's
        own group (``batch_isend_irecv`` with nccl): no process group is
        created, since ``new_group`` is collective over every process of
        the job, which ranks working on a subgroup cannot all call."""
        line = self.line(axis)
        chunks = [c.contiguous() for c in chunks]
        if len(chunks) != len(line):
            raise ValueError(f"all_to_all: {len(chunks)} chunks for a line of {len(line)} ranks")
        if len(line) == 1:
            return chunks
        pos = line.index(self.rank)
        seq = next(self._tags)
        staged = self._staged(chunks[0])
        sends, recvs = [], []
        for k, peer in enumerate(line):
            if k == pos:
                continue
            c = chunks[k]
            if staged:
                buf = self._host(c, ("a2a-send", k, seq % 2))
                buf.copy_(c)
                c = buf
            recv = self._host(c, ("a2a-recv", k, seq % 2)) if staged else torch.empty_like(c)
            sends.append((peer, c, 2 * seq))
            recvs.append((peer, recv, 2 * seq))
        for w in self._p2p(sends, recvs):
            w.wait()
        out = [r.to(chunks[0].device) if staged else r for _, r, _ in recvs]
        out.insert(pos, chunks[pos])
        return out


class SlabComm(_Collectives):
    """The 1-D communicator of an owned-slab partition (the adaptive
    meshes, ``parallel/dist_adaptive.py``): this rank's slab index ``rank``
    of ``n_shards``, the all-reduce, the all-gather and the gather to rank
    0; no neighbours, no planes. A new partition on the same group (an AMR
    step) takes a new ``SlabComm``; it creates no group."""

    def __init__(self, n_shards: int, device, group=None):
        self.n_shards = n_shards
        self._setup(device, group, n_shards)


def rank_device(comm=None, device=None) -> torch.device:
    """The device of a rank's operator: ``comm.device`` when there is a
    comm, else ``device``, by default ``cuda`` (``resolve_device``: a CUDA
    device without a card raises)."""
    return comm.device if comm is not None else resolve_device("cuda" if device is None else device)


def init_shards(pz: int, py: int = 1, px: int = 1, backend: str = "nccl", device: str | None = None):
    """Join the process group of a ``torchrun`` launch (``env://``: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) for a ``pz x py x px`` partition;
    returns ``(rank, device)``. With no ``device`` a rank takes card
    ``LOCAL_RANK`` (nccl), or ``LOCAL_RANK`` modulo the card count (gloo:
    ranks may share a card), and raises when there is no card; ``device``
    overrides (``cuda:0`` for every gloo rank, or ``cpu``)."""
    n = pz * py * px
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("init_shards: no CUDA card; the port never falls back to the CPU silently "
                           "(pass device='cpu' with the gloo backend)")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    if dist.get_world_size() != n:
        raise ValueError(f"{dist.get_world_size()} ranks for a {pz}x{py}x{px} partition")
    rank = dist.get_rank()
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local if backend == 'nccl' else local % torch.cuda.device_count()}"
    dev = torch.device(device)
    _check_backend(backend, n, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return rank, dev


def _child(rank, n, backend, store_path, fn, args, queue, timeout_s):
    try:
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, result))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, n: int, args=(), backend: str = "gloo", device: str = "cpu", timeout: float = 120.0):
    """Run ``fn(rank, *args)`` on ``n`` ranks, each a new process joined by a
    ``FileStore`` in a temporary directory (no ports); returns the ranks'
    results in rank order. ``fn`` must be importable (a module-level
    function). Raises as soon as a rank fails, or if the ranks do not all
    finish within ``timeout`` seconds; the other ranks are then killed."""
    import queue as queue_mod
    import time

    import torch.multiprocessing as mp

    _check_backend(backend, n, torch.device(device))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="shards-") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(r, n, backend, store_path, fn, args, q, timeout), daemon=True)
                 for r in range(n)]
        for pr in procs:
            pr.start()
        results = {}
        t_end = time.monotonic() + timeout
        try:
            while len(results) < n:
                try:
                    rank, ok, val = q.get(timeout=max(0.0, min(t_end - time.monotonic(), 2.0)))
                except queue_mod.Empty:
                    if time.monotonic() >= t_end:
                        raise TimeoutError(f"spawn: {n - len(results)} of {n} ranks did not finish in "
                                           f"{timeout:.0f} s") from None
                    dead = [r for r, pr in enumerate(procs) if pr.exitcode not in (None, 0) and r not in results]
                    if dead and q.empty():
                        raise RuntimeError(f"spawn: rank(s) {dead} of {n} died without a result") from None
                    continue
                if not ok:
                    # the first failure often takes the others down: gather
                    # what arrives in a few seconds and report every one
                    errors = {rank: val}
                    t_grace = time.monotonic() + 3.0
                    while time.monotonic() < t_grace:
                        try:
                            r2, ok2, v2 = q.get(timeout=0.5)
                        except queue_mod.Empty:
                            continue
                        if not ok2:
                            errors[r2] = v2
                    raise RuntimeError(f"spawn: rank(s) {sorted(errors)} of {n} failed:\n"
                                       + "\n".join(f"--- rank {r}:\n{tb}" for r, tb in sorted(errors.items())))
                results[rank] = val
        finally:
            for pr in procs:
                pr.join(timeout=10 if len(results) == n else 0.1)
                if pr.is_alive():
                    pr.kill()
                    pr.join()
    return [results[r] for r in range(n)]
