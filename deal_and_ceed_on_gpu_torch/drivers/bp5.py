"""BP5 benchmark driver: mesh-size sweep, four benchmark modes, validation.

Counterpart of ``deal_and_ceed_on_gpu_tpu/drivers/bp5.py`` and of the
reference's ``PoissonProblem`` driver (``bp5/step-64.cu:280-679``). Output
lines match the reference format so result tables are comparable:

    pcg-standard <dofs/rank> <max_throughput>
    pcg-merged   <dofs/rank> <max_throughput>
    vmult        <dofs/rank> <max_throughput>
    pcg-fused    <dofs/rank> <max_throughput>   (K5, --backend stencil only)
    fdm-direct   <dofs/rank> <dofs / best solve time>
    pcg-ir       <dofs/rank> <max_throughput over inner iterations>
    pcg-mg       <dofs/rank> <max_throughput>

Throughput = DoFs * iterations / wall_time, max over repetitions
(``bp5/step-64.cu:458-463``); timing fences with ``torch.cuda.synchronize``.

Backends: ``stencil`` (K1), ``banded`` (K2), ``qgrid`` (K3), ``general``
(K4), and the plain torch ``separable``, ``structured`` and ``gather`` (the
indexed ``local_to_global`` transfer with the deterministic sorted scatter).
``auto`` picks one a cycle by the JAX driver's policy (``resolve_backend``):
``general`` for a Gauss rule or a mesh that is not a uniform brick, else
``stencil`` from ``AUTO_THRESHOLDS`` DoFs on (per dtype and stream dtype,
from an H100 sweep, ``scripts/sweep_auto.py``) and ``separable`` below; it
prints ``backend auto -> <name>``.

The vmult mode chains ``v <- A v`` with ``1/lambda_est`` folded into the
operator tables (``fold_scale``), so every step is one pure apply and f32
cannot overflow across the chain.

Beyond the reference: ``fdm-direct`` is the fast-diagonalization direct
solve (``solvers/fdm.py``, one apply), ``pcg-ir`` mixed-precision iterative
refinement to a true f64 relative residual of 1e-10 (``solvers/ir.py``,
``--dtype float64``: f32 inner merged CG on the same backend, with
``--stream-dtype bfloat16`` passed to the f32 operator; the f64 operator
runs on the same backend, the card's kernels being native f64), and
``pcg-mg`` plain CG with the geometric multigrid V-cycle
(``solvers/multigrid.py``) whose levels are built on the driver's backend.

``--device`` defaults to ``cuda`` and raises when no card is present: the
driver never drops to the CPU silently. ``--device cpu`` runs the plain
torch versions of the kernels (the test path).

Distributed (``--shards PZxPY[xPX]``, ``run_cycle_distributed``): the mesh
is cut into blocks, one a rank (``parallel/``), and pcg-standard,
pcg-merged, fdm-direct (the distributed FDM solve, ``parallel.DistFDM``:
all-to-all transposes within the ranks' lines) and vmult run on every
rank's block, with the JAX driver's per-rank lines (DoFs a rank, DoF/s a
rank). ``--write-solution PATH.pvtr`` writes the pcg-merged solution as one
``.vtr`` piece a rank plus a ``.pvtr`` master
(``utils/vtk.write_solution_pvtr``; rank 0 gathers the blocks and writes
the files). The backend ``stencil`` runs K1
in shard mode (``parallel.DistStencilOperator``, overlapped halo
exchange; ``--no-overlap`` exchanges after the apply), the others ``parallel.DistOperator``. ``--dist-backend``: the
``torch.distributed`` backend, ``nccl`` (one card a rank; more ranks than
cards raise) or ``gloo`` (ranks may share a card, or run on the CPU). Under
``torchrun`` the ranks are its processes; otherwise the driver starts them
(``parallel.spawn``).

Run: ``python -m deal_and_ceed_on_gpu_torch.drivers.bp5 --cycle-min 10
--cycle-max 12 --dtype float32 --backend stencil``; ``--modes
fdm-direct,pcg-ir,pcg-mg --dtype float64`` for the extra solvers;
``--shards 2x2 --dist-backend gloo`` for four ranks sharing one card.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..fe_space import FESpace, resolve_device
from ..mesh import BrickMesh
from ..models import PoissonOperator, assemble_rhs, l2_norm_function
from ..solvers import (
    FDMSolver,
    IterationNumberControl,
    Multigrid,
    solve_cg,
    solve_cg_fused,
    solve_cg_ir,
    solve_cg_merged,
)
from ..utils.logging import rank0_print as pcout
from ..utils.timer import Timer

__all__ = ["AUTO_THRESHOLDS", "BP5Config", "run_cycle", "run_cycle_distributed", "run", "main", "DEFAULT_MODES",
           "PORTED_MODES", "BACKENDS", "resolve_backend", "resolve_device"]

# the JAX driver's default modes (drivers/bp5.py BP5Config.modes)
DEFAULT_MODES = ("pcg-standard", "pcg-merged", "vmult")
# every mode of the JAX driver
PORTED_MODES = DEFAULT_MODES + ("pcg-fused", "fdm-direct", "pcg-ir", "pcg-mg")
# stencil: K1; banded: K2; qgrid: K3; general: K4; separable / structured /
# gather: plain torch; auto: one of them a cycle (resolve_backend)
BACKENDS = ("stencil", "banded", "qgrid", "general", "separable", "structured", "gather", "auto")
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}
# --backend auto on a uniform GLL brick: K1 (stencil) from this many DoFs,
# separable below, per (dtype, stream dtype). From scripts/sweep_auto.py on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit, cycles 7..40 (1,936 to
# 131,892,801 DoFs): K1's apply is 4.5-20x faster than separable's at every
# cycle in f64, f32 and bf16-streamed vectors, so every threshold is 0 (K1
# at every size); the TPU's 6M / 4M thresholds do not carry over.
AUTO_THRESHOLDS = {
    ("float64", None): 0,
    ("float32", None): 0,
    ("float32", "bfloat16"): 0,
}


@dataclasses.dataclass
class BP5Config:
    degree: int = 5
    n_iterations: int = 200
    n_repetitions: int = 10
    dtype: str = "float32"
    backend: str = "stencil"  # one of BACKENDS
    rule: str = "gauss_lobatto"  # BP5 collocation
    n_q: int | None = None
    modes: tuple = DEFAULT_MODES
    validate: bool = True
    # stream the solver vectors at this dtype ("bfloat16" halves their
    # bytes) while the apply, the dots and the recurrences run at ``dtype``
    stream_dtype: str | None = None
    device: str = "cuda"
    # distributed stencil (--shards): send the shared planes' partials before
    # the full apply (True) or exchange the planes after it (False)
    overlap: bool = True


def resolve_backend(cfg: "BP5Config", mesh: BrickMesh) -> str:
    """``cfg.backend``, or for ``auto`` the JAX driver's policy
    (``drivers/bp5.py:125-143``): ``general`` (K4) for a Gauss rule or a
    mesh that is not a uniform brick, else ``stencil`` (K1) at or above the
    DoF threshold of ``AUTO_THRESHOLDS`` for the dtype and stream dtype
    (the stream dtype counts with f32 compute only) and ``separable``
    below it."""
    if cfg.backend != "auto":
        return cfg.backend
    if cfg.rule != "gauss_lobatto" or not mesh.is_uniform:
        return "general"
    stream = cfg.stream_dtype if cfg.dtype == "float32" else None
    return "stencil" if mesh.n_dofs(cfg.degree) >= AUTO_THRESHOLDS[(cfg.dtype, stream)] else "separable"


def _resolve(cfg: "BP5Config", mesh: BrickMesh) -> "BP5Config":
    backend = resolve_backend(cfg, mesh)
    if cfg.backend == "auto":
        pcout(f"   backend auto -> {backend}")
    return dataclasses.replace(cfg, backend=backend)


def _throughput_lines(label, n_dofs, times, iters, n_ranks=1):
    """The reference's lines: per solve, then ``label <DoFs a rank> <best
    DoF/s a rank>``."""
    tp = [n_dofs * it / t / n_ranks for t, it in zip(times, iters)]
    for t, it, th in zip(times, iters, tp):
        pcout(f"   Solved in {it} iterations with time {t:.6f} and DoFs/s {th:.6g}")
    best = max(tp)
    pcout(f"{label} {n_dofs // n_ranks} {best:.6g}")
    pcout("")
    return best


def estimate_lambda_max(op, n_dofs, iters=12, seed=0, block=None, dot_weight=None, comm=None):
    """Crude power-iteration bound on the operator spectral radius (used only
    to scale the chained vmult benchmark); the same numpy draws as the JAX
    driver. A distributed operator passes ``block`` (the global draws ->
    this rank's block), its ``dot_weight`` (0 on the planes the rank
    duplicates) and ``comm``: the norms are then weighted and all-reduced."""
    dtype, device = (op.space.dtype, op.space.device) if dot_weight is None else (dot_weight.dtype, dot_weight.device)
    g = np.random.default_rng(seed).standard_normal(n_dofs)
    u = torch.as_tensor(g if block is None else block(g), dtype=dtype, device=device)

    def norm(v):
        if comm is None:
            return torch.linalg.vector_norm(v)
        return torch.sqrt(comm.allreduce_sum_(torch.dot((v * dot_weight).reshape(-1), v.reshape(-1)).reshape(1)))[0]

    u = u / norm(u)
    lam = torch.ones((), dtype=dtype, device=device)
    for _ in range(iters):
        # back to the probe dtype: bf16-streaming operators return bf16
        v = op.vmult(u).to(u.dtype)
        lam = norm(v)
        u = v / lam
    return float(lam)


def _true_rel_res(op, b, x) -> float:
    """``|b - A x| / |b|`` at the compute dtype."""
    dt = op.space.dtype
    b = b.to(dt)
    return float(torch.linalg.vector_norm(b - op.vmult(x).to(dt)) / torch.linalg.vector_norm(b))


def _repeat(label, solve, cfg, n_dofs, results):
    """Warm up, then time ``cfg.n_repetitions`` solves; record the
    throughput, the last iteration count and whether x stayed finite."""
    x, info = solve()
    times, iters = [], []
    for _ in range(cfg.n_repetitions):
        t = Timer().start()
        x, info = solve()
        t.stop(fence=x)
        times.append(t.elapsed)
        iters.append(int(info["n_iterations"]))
    results[label] = _throughput_lines(label, n_dofs, times, iters)
    results["n_iterations"][label] = iters[-1]
    results["finite"][label] = bool(torch.isfinite(x).all())
    return x


def run_cycle(cycle: int, cfg: BP5Config | None = None, **overrides):
    """One BP5 cycle; ``overrides`` replace fields of ``cfg``. Returns the
    per-mode throughputs plus ``n_iterations``, ``finite`` (per mode) and
    ``l2_norm`` (when validating)."""
    cfg = dataclasses.replace(cfg or BP5Config(), **overrides)
    unknown = set(cfg.modes) - set(PORTED_MODES)
    if unknown:
        raise ValueError(f"unknown modes {sorted(unknown)}")
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}: expected one of {BACKENDS}")
    device = resolve_device(cfg.device)
    dtype = DTYPES[cfg.dtype]
    stream32 = None if cfg.stream_dtype is None else DTYPES[cfg.stream_dtype]
    # bf16 vectors pair with f32 compute; with --dtype float64 the streaming
    # dtype goes to pcg-ir's f32 inner operator only
    stream = stream32 if stream32 is not None and dtype == torch.float32 else dtype
    mesh = BrickMesh.bp5_cycle(cycle)
    cfg = _resolve(cfg, mesh)
    space = FESpace.create(
        mesh, cfg.degree, n_q=cfg.n_q, rule=cfg.rule, dtype=dtype, device=device
    )
    op = PoissonOperator(space, backend=cfg.backend, stream_dtype=stream)
    pcout(f"Cycle {cycle}")
    pcout(f"   Number of active cells:       {mesh.n_cells}")
    pcout(f"   Number of degrees of freedom: {space.n_dofs}")
    pcout("")

    b = assemble_rhs(space, 1.0)
    norm_b = float(torch.linalg.vector_norm(b))
    control = IterationNumberControl(cfg.n_iterations, 1e-6 * norm_b)
    # the solves run on vectors at the streaming dtype; with bf16 vectors
    # the dots and recurrences accumulate at the compute dtype (bf16 sums
    # over 10^7 entries are meaningless). diag=None is the reference's
    # identity DiagonalMatrix without streaming a ones vector.
    b_solve = b.to(stream)
    dot_dtype = dtype if stream != dtype else None
    vm = op.vmult

    results = {"n_iterations": {}, "finite": {}, "true_rel_res": {}}
    solution = None

    if "pcg-standard" in cfg.modes:
        solution = _repeat(
            "pcg-standard",
            lambda: solve_cg(vm, b_solve, control, dot_dtype=dot_dtype),
            cfg, space.n_dofs, results,
        )

    if "pcg-merged" in cfg.modes:
        solution = _repeat(
            "pcg-merged",
            lambda: solve_cg_merged(vm, b_solve, control, dot_dtype=dot_dtype),
            cfg, space.n_dofs, results,
        )

    if "pcg-fused" in cfg.modes:
        # the whole iteration (update, apply, dots) in one K5 launch
        # (ops/cg.py); K5 is built on K1's tables, so stencil only
        if cfg.backend != "stencil":
            pcout("pcg-fused requires --backend stencil — skipping")
        else:
            solution = _repeat(
                "pcg-fused", lambda: solve_cg_fused(op, b_solve, control), cfg, space.n_dofs, results
            )

    if "fdm-direct" in cfg.modes:
        # the Kronecker fast-diagonalization direct solve: one apply replaces
        # the CG loop; the throughput line counts it as one iteration
        fdm = FDMSolver(space)
        x = fdm.solve(b)
        times = []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            x = fdm.solve(b)
            t.stop(fence=x)
            times.append(t.elapsed)
        rel = _true_rel_res(op, b, x)
        for t in times:
            pcout(f"   FDM direct solve in time {t:.6f} (rel res {rel:.2e})")
        best = min(times)
        pcout(f"fdm-direct {space.n_dofs} {space.n_dofs / best:.6g}")
        pcout("")
        results["fdm-direct"] = space.n_dofs / best
        results["true_rel_res"]["fdm-direct"] = rel
        results["finite"]["fdm-direct"] = bool(torch.isfinite(x).all())
        solution = x

    if "pcg-ir" in cfg.modes:
        # mixed-precision iterative refinement to a true f64 relative
        # residual of 1e-10: f32 (or bf16-streaming) merged-CG inner solves
        # on the same backend, f64 residuals
        if dtype != torch.float64:
            pcout("pcg-ir requires --dtype float64 — skipping")
        else:
            space32 = FESpace.create(
                mesh, cfg.degree, n_q=cfg.n_q, rule=cfg.rule, dtype=torch.float32, device=device
            )
            op32 = PoissonOperator(space32, backend=cfg.backend, stream_dtype=stream32)
            x, info = solve_cg_ir(op32, op, b, rtol=1e-10)
            times, its = [], []
            for _ in range(cfg.n_repetitions):
                t = Timer().start()
                x, info = solve_cg_ir(op32, op, b, rtol=1e-10)
                t.stop(fence=x)
                times.append(t.elapsed)
                its.append(int(info["n_inner"]))
            for t, it in zip(times, its):
                pcout(
                    f"   IR solved to true rel. res {info['res_rel']:.2e} "
                    f"({info['n_outer']} outer / {it} inner) in {t:.6f}"
                )
            tp = [space.n_dofs * it / t for t, it in zip(times, its)]
            pcout(f"pcg-ir {space.n_dofs} {max(tp):.6g}")
            pcout("")
            results["pcg-ir"] = max(tp)
            results["n_iterations"]["pcg-ir"] = (info["n_outer"], its[-1])
            results["true_rel_res"]["pcg-ir"] = info["res_rel"]
            results["finite"]["pcg-ir"] = bool(torch.isfinite(x).all())
            solution = x

    if "pcg-mg" in cfg.modes:
        # plain CG with the geometric multigrid V-cycle, every level on the
        # driver's backend (a level the kernel cannot take raises)
        fine = op if op.stream_dtype == dtype else PoissonOperator(space, backend=cfg.backend)
        mg = Multigrid(space, make_op=lambda s: PoissonOperator(s, backend=cfg.backend), fine_op=fine)
        solution = _repeat(
            "pcg-mg",
            lambda: solve_cg(vm, b_solve, control, diag=mg.vcycle, dot_dtype=dot_dtype),
            cfg, space.n_dofs, results,
        )
        results["true_rel_res"]["pcg-mg"] = _true_rel_res(op, b, solution)

    if "vmult" in cfg.modes:
        op.fold_scale(1.0 / estimate_lambda_max(op, space.n_dofs))
        b_c = b_solve.to(dtype)
        u0 = (b_c / torch.linalg.vector_norm(b_c)).to(stream)

        def chain(u):
            for _ in range(cfg.n_iterations):
                u = vm(u)
            return u

        out = chain(u0)
        times = []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            out = chain(u0)
            t.stop(fence=out)
            times.append(t.elapsed)
        tp = [space.n_dofs * cfg.n_iterations / t for t in times]
        for t, th in zip(times, tp):
            pcout(f"   {cfg.n_iterations} mat-vecs in time {t:.6f} and DoFs/s {th:.6g}")
        results["vmult"] = max(tp)
        results["finite"]["vmult"] = bool(torch.isfinite(out).all())
        pcout(f"vmult {space.n_dofs} {max(tp):.6g}")
        pcout("")

    if cfg.validate and solution is not None:
        norm = float(l2_norm_function(space, solution.to(dtype)))
        pcout(f"   solution L2 norm: {norm:.12g}")
        results["l2_norm"] = norm
        pcout("")

    return results


DIST_MODES = ("pcg-standard", "pcg-merged", "fdm-direct", "vmult")


def run_cycle_distributed(cycle: int, pz: int, py: int = 1, cfg: BP5Config | None = None, px: int = 1,
                          comm=None, write_solution: str | None = None, **overrides):
    """One BP5 cycle on this rank's block of a ``pz x py x px`` partition
    (JAX ``drivers/bp5.py:492-640``). With ``write_solution`` (a
    ``.pvtr`` path) rank 0 writes the pcg-merged solution there, one
    ``.vtr`` piece a rank beside it (``utils/vtk.write_solution_pvtr``).
    Called by every rank of the process group, with this rank's
    device as ``cfg.device`` (or a ``ShardComm``). ``fdm-direct`` is the
    distributed FDM solve (``parallel.DistFDM``, eight all-to-alls an
    apply; ``pz x py`` partitions), its true residual taken on rank 0 by the
    single-device operator of ``cfg.backend`` on the assembled solution.
    Returns the per-mode throughputs a rank, ``n_iterations`` and ``finite``
    per mode, ``ms_per_iteration`` per solve mode (this rank's wall clock;
    fdm-direct: one apply), ``coherent`` (the shared planes of the last
    solution bitwise equal on every pair of sharers) and, on rank 0,
    ``l2_norm`` of the solution assembled from the blocks and
    ``true_rel_res`` of fdm-direct."""
    import torch.distributed as dist

    from ..parallel import (
        BlockPartition,
        DistFDM,
        DistOperator,
        DistStencilOperator,
        ShardComm,
        solve_cg_dist,
        solve_cg_merged_dist,
    )

    cfg = dataclasses.replace(cfg or BP5Config(), **overrides)
    unknown = set(cfg.modes) - set(DIST_MODES)
    if unknown:
        raise ValueError(f"distributed modes are {DIST_MODES}; not ported: {sorted(unknown)}")
    dtype = DTYPES[cfg.dtype]
    stream = dtype if cfg.stream_dtype is None else DTYPES[cfg.stream_dtype]
    mesh = BrickMesh.bp5_cycle(cycle)
    cfg = _resolve(cfg, mesh)
    if stream != dtype and cfg.backend != "stencil":
        raise ValueError("distributed --stream-dtype needs --backend stencil")
    part = BlockPartition(mesh, cfg.degree, pz, py, px)
    if comm is None:
        comm = ShardComm(part, resolve_device(cfg.device))
    device = comm.device
    n_ranks = part.n_shards
    if cfg.backend == "stencil":
        dist_op = DistStencilOperator(part, comm, dtype, stream_dtype=stream, overlap=cfg.overlap)
    else:
        dist_op = DistOperator(part, comm, PoissonOperator, dtype, backend=cfg.backend, rule=cfg.rule, n_q=cfg.n_q)
    halo = "" if cfg.backend != "stencil" else ", halo " + ("overlapped" if cfg.overlap else "after the apply")
    pcout(f"Cycle {cycle} on {pz}x{py}x{px} shards{halo}")
    pcout(f"   Number of active cells:       {mesh.n_cells}")
    n_dofs = int(np.prod(part.global_grid_shape))
    pcout(f"   Number of degrees of freedom: {n_dofs}")

    # the right-hand side: the global vector on every rank, then its block
    gspace = FESpace.create(mesh, cfg.degree, n_q=cfg.n_q, rule=cfg.rule, dtype=dtype, device=device)
    b_global = assemble_rhs(gspace, 1.0)
    norm_b = float(torch.linalg.vector_norm(b_global))
    b = torch.as_tensor(part.block(b_global.cpu().numpy().reshape(part.global_grid_shape), comm.rank),
                        device=device)
    if comm.rank != 0 or "fdm-direct" not in cfg.modes:
        del b_global  # rank 0 keeps it for fdm-direct's true residual
    control = IterationNumberControl(cfg.n_iterations, 1e-6 * norm_b)
    results = {"n_iterations": {}, "finite": {}, "ms_per_iteration": {}, "true_rel_res": {}}
    solution = None

    def fence(x):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        dist.barrier(group=comm.group)

    for label, solver in (("pcg-standard", solve_cg_dist), ("pcg-merged", solve_cg_merged_dist)):
        if label not in cfg.modes:
            continue
        x, info = solver(dist_op, b, control)
        times, iters = [], []
        for _ in range(cfg.n_repetitions):
            fence(x)
            t = Timer().start()
            x, info = solver(dist_op, b, control)
            t.stop(fence=x)
            times.append(t.elapsed)
            iters.append(int(info["n_iterations"]))
        results[label] = _throughput_lines(label, n_dofs, times, iters, n_ranks)
        results["n_iterations"][label] = iters[-1]
        results["finite"][label] = bool(torch.isfinite(x).all())
        results["ms_per_iteration"][label] = 1e3 * min(times) / max(iters[-1], 1)
        solution = x
        if label == "pcg-merged" and write_solution:
            # one .vtr piece a rank + the .pvtr master (the reference's
            # per-rank VTU + PVTU record, step-64/step-64.cu:560-588)
            blocks = comm.gather_blocks(x.to(dtype))
            if comm.rank == 0:
                from ..utils.vtk import write_solution_pvtr

                flat = np.zeros(part.flat_grid_shape)
                for r, blk in enumerate(blocks):
                    flat[part._block_slices(r)] = blk
                write_solution_pvtr(write_solution, part, flat)
                pcout(f"   wrote {write_solution} (+ per-shard pieces)")

    if "fdm-direct" in cfg.modes:
        # the distributed exact FDM solve: one apply, eight all-to-alls
        fdm = DistFDM(part, comm, dtype, rule=cfg.rule, n_q=cfg.n_q)
        x = fdm.solve_direct(b)
        times = []
        for _ in range(cfg.n_repetitions):
            fence(x)
            t = Timer().start()
            x = fdm.solve_direct(b)
            t.stop(fence=x)
            times.append(t.elapsed)
        blocks = comm.gather_blocks(x)
        if comm.rank == 0:
            x_global = torch.as_tensor(part.assemble(blocks).reshape(-1), device=device)
            op_chk = PoissonOperator(gspace, backend=cfg.backend)
            rel = float(torch.linalg.vector_norm(b_global - op_chk.vmult(x_global)) / norm_b)
            results["true_rel_res"]["fdm-direct"] = rel
            del op_chk, x_global, b_global
            for t in times:
                pcout(f"   FDM direct solve in time {t:.6f} (rel res {rel:.2e})")
        best = min(times)
        pcout(f"fdm-direct {n_dofs // n_ranks} {n_dofs / best / n_ranks:.6g}")
        pcout("")
        results["fdm-direct"] = n_dofs / best / n_ranks
        results["finite"]["fdm-direct"] = bool(torch.isfinite(x).all())
        results["ms_per_iteration"]["fdm-direct"] = 1e3 * best
        solution = x

    if "vmult" in cfg.modes:
        lam = estimate_lambda_max(dist_op, n_dofs, block=lambda g: part.block(g.reshape(part.global_grid_shape),
                                                                              comm.rank),
                                  dot_weight=dist_op.dot_weight, comm=comm)
        dist_op.fold_scale(1.0 / lam)
        u0 = (b.to(dtype) / norm_b).to(stream)

        def chain(u):
            for _ in range(cfg.n_iterations):
                u = dist_op.vmult(u)
            return u

        out = chain(u0)
        times = []
        for _ in range(cfg.n_repetitions):
            fence(out)
            t = Timer().start()
            out = chain(u0)
            t.stop(fence=out)
            times.append(t.elapsed)
        tp = [n_dofs * cfg.n_iterations / t / n_ranks for t in times]
        for t, th in zip(times, tp):
            pcout(f"   {cfg.n_iterations} mat-vecs in time {t:.6f} and DoFs/s {th:.6g}")
        results["vmult"] = max(tp)
        results["finite"]["vmult"] = bool(torch.isfinite(out).all())
        results["ms_per_iteration"]["vmult"] = 1e3 * min(times) / cfg.n_iterations
        pcout(f"vmult {n_dofs // n_ranks} {max(tp):.6g}")
        pcout("")

    if solution is not None:
        results["coherent"] = comm.shared_planes_equal(solution)
        blocks = comm.gather_blocks(solution.to(dtype))
        if comm.rank == 0 and cfg.validate:
            x_global = torch.as_tensor(part.assemble(blocks).reshape(-1), device=device)
            norm = float(l2_norm_function(gspace, x_global))
            pcout(f"   solution L2 norm: {norm:.12g}")
            results["l2_norm"] = norm
            pcout("")
    return results


def _rank_main(rank, cycles, shards, cfg, dist_backend, write_solution=None):
    """A driver rank (``parallel.spawn``): its device, then the cycles."""
    import torch

    pz, py, px = shards
    if torch.device(cfg.device).type == "cuda":
        cfg = dataclasses.replace(cfg, device=f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(torch.device(cfg.device))
    return [run_cycle_distributed(c, pz, py, cfg, px, write_solution=write_solution) for c in cycles]


def run_distributed(cycle_min: int, cycle_max: int, shards, cfg: BP5Config, dist_backend: str = "nccl",
                    timeout: float = 3600.0, write_solution: str | None = None):
    """The distributed cycles on ``pz x py x px`` ranks: under ``torchrun``
    (``RANK`` set) in this process, else on ranks the driver starts. Returns
    the ranks' results (this rank's alone under torchrun). ``write_solution``:
    see ``run_cycle_distributed`` (each cycle writes the same path)."""
    import os

    from ..parallel import init_shards, spawn

    pz, py, px = shards
    cycles = list(range(cycle_min, cycle_max + 1))
    if "RANK" in os.environ:
        _, device = init_shards(pz, py, px, dist_backend,
                                None if dist_backend == "nccl" else str(resolve_device(cfg.device)))
        return [run_cycle_distributed(c, pz, py, dataclasses.replace(cfg, device=str(device)), px,
                                      write_solution=write_solution) for c in cycles]
    resolve_device(cfg.device)
    return spawn(_rank_main, pz * py * px, args=(cycles, shards, cfg, dist_backend, write_solution),
                 backend=dist_backend, device=cfg.device, timeout=timeout)


def run(cycle_min=7, cycle_max=40, cfg: BP5Config | None = None):
    cfg = cfg or BP5Config()
    return {cycle: run_cycle(cycle, cfg) for cycle in range(cycle_min, cycle_max + 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description="BP5 benchmark (PyTorch + CUDA)")
    ap.add_argument("--cycle-min", type=int, default=7)
    ap.add_argument("--cycle-max", type=int, default=40)
    ap.add_argument("--degree", type=int, default=5)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--repetitions", type=int, default=10)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument(
        "--backend", default="stencil", choices=BACKENDS,
        help="stencil: the K1 CUDA kernel (GLL collocation, uniform brick); banded: K2; "
        "qgrid: K3 (--rule gauss); general: K4; separable / structured / gather (indexed "
        "local_to_global, sorted scatter): plain torch; auto: stencil from the H100 sweep's DoF "
        "threshold, separable below it, general for --rule gauss",
    )
    ap.add_argument("--rule", default="gauss_lobatto", choices=["gauss_lobatto", "gauss"])
    ap.add_argument(
        "--modes", default=",".join(DEFAULT_MODES),
        help=f"comma list of {', '.join(PORTED_MODES)} (pcg-ir needs --dtype float64)",
    )
    ap.add_argument(
        "--stream-dtype", default=None, choices=["bfloat16"],
        help="store the solver vectors at this dtype; the apply and the dots "
        "accumulate at --dtype",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--shards", default="1", help="PZxPY[xPX]: the block partition (one rank a block); 1: one device")
    ap.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                    help="torch.distributed backend of --shards: nccl (one card a rank) or gloo (ranks may share a "
                    "card or run on the CPU)")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="distributed stencil: exchange the shared planes after the apply, not its partials before")
    ap.add_argument("--write-solution", default=None, metavar="PATH.pvtr",
                    help="distributed runs: write the pcg-merged solution as one .vtr piece a rank plus a .pvtr "
                    "master at this path")
    args = ap.parse_args(argv)
    cfg = BP5Config(
        degree=args.degree,
        n_iterations=args.iterations,
        n_repetitions=args.repetitions,
        dtype=args.dtype,
        backend=args.backend,
        rule=args.rule,
        modes=tuple(args.modes.split(",")),
        stream_dtype=args.stream_dtype,
        device=args.device,
        overlap=args.overlap,
    )
    shards = tuple((int(s) for s in args.shards.split("x")))
    pz, py, px = (shards + (1, 1))[:3]
    if pz * py * px > 1:
        if set(cfg.modes) - set(DIST_MODES):
            cfg = dataclasses.replace(cfg, modes=tuple(m for m in cfg.modes if m in DIST_MODES))
            pcout(f"distributed runs take the modes {', '.join(DIST_MODES)}; running {', '.join(cfg.modes)}")
        run_distributed(args.cycle_min, args.cycle_max, (pz, py, px), cfg, args.dist_backend,
                        write_solution=args.write_solution)
    else:
        run(args.cycle_min, args.cycle_max, cfg)


if __name__ == "__main__":
    main()
