"""The distributed adaptive meshes (``parallel/dist_adaptive.py``,
``dist_adaptive_mg.py``, ``dist_amr.py``) on spawned gloo CPU ranks,
against the JAX package's distributed adaptive classes under ``shard_map``
on the 8 virtual CPU devices (``tests/conftest.py``) and the port's
single-device adaptive operator, multigrid and AMR loop.

One spawn of 8 ranks runs every case (a module fixture); a case on fewer
ranks runs on a subgroup. Covered: a two-level hanging-node mesh on 2 and
3 ranks (p = 2, 3), the ball-refined 4^3 brick (two rounds) on 4 ranks,
Poisson and Helmholtz (``a=``) vmults, merged CG, one V-cycle and MG-CG,
the transfers (the written-out restriction is the transpose of the
prolongation), the distributed ZZ estimator and the distributed AMR loop
on 8 ranks (the JAX dryrun's check 16). The cell loop is K4 on each
rank's packed cells, whose wrapper runs its plain version on these CPU
tensors. Tolerances: applies and V-cycles 1e-12 (JAX's gloo
all-reduce sums in another order than ``psum``), iterations +-1,
solutions rtol 1e-7 / atol 1e-9 (the dryrun's), adjoints 1e-13."""

import contextlib
import os

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.adaptive import (AdaptiveHelmholtzOperator, AdaptiveMesh, AdaptivePoissonOperator,
                                                 AdaptiveSpace, assemble_rhs_adaptive, estimate_gradient_recovery)

N_RANKS = 8
SPAWN_TIMEOUT = 150.0
AMR_KW = dict(n_steps=2, theta=0.4, reduction=1e-8, max_iterations=300)


def _coef(X):
    return 1.0 + X[..., 0] ** 2 + 0.5 * X[..., 2]


def _two_level(mesh_cls, brick):
    amesh = mesh_cls.refine(brick((2, 2, 2)), (0, 7))
    child = int(np.flatnonzero(amesh.levels == 1)[0])
    return amesh.refine_active((child,))


def _ball(mesh_cls, brick, rounds=2):
    amesh = mesh_cls.from_brick(brick((4, 4, 4)))
    for _ in range(rounds):
        ctr = amesh.origins + 0.5 * amesh.sizes
        amesh = amesh.refine_active(np.linalg.norm(ctr - 0.5 * np.asarray(amesh.upper), axis=1)
                                    < 0.3 * amesh.upper[0])
    return amesh


# name -> (ranks, mesh, p)
CASES = {
    "two_level_2": (2, "two_level", 2),
    "two_level_3": (3, "two_level", 3),
    "ball_4": (4, "ball", 2),
}
JAX_CASES = ["ball_4"]  # the JAX runs compile for ~15 s a case; the others are held to the single-device port


def _mesh(kind, jax=False):
    if jax:
        from deal_and_ceed_on_gpu_tpu import BrickMesh
        from deal_and_ceed_on_gpu_tpu.adaptive import AdaptiveMesh as JMesh

        return (_two_level if kind == "two_level" else _ball)(JMesh, BrickMesh)
    return (_two_level if kind == "two_level" else _ball)(AdaptiveMesh, pt.BrickMesh)


def _space(kind, p):
    return AdaptiveSpace(_mesh(kind), p, device="cpu")


def _probe(n):
    return np.random.default_rng(3).standard_normal(n)


def _control():
    return pt.ReductionControl(800, tolerance=0.0, reduction=1e-10)


def _dot(comm, u, v):
    return float(comm.allreduce_sum_(torch.dot(u.reshape(-1), v.reshape(-1)).reshape(1))[0])


def _run_case(rank, n, kind, p, group):
    from deal_and_ceed_on_gpu_torch.parallel import (AdaptivePartition, DistAdaptiveMultigrid, DistAdaptivePoisson,
                                                     SlabComm, estimate_gradient_recovery_dist,
                                                     solve_cg_merged_dist_adaptive, solve_cg_mg_dist_adaptive)

    space = _space(kind, p)
    part = AdaptivePartition(space, n)
    comm = SlabComm(n, "cpu", group)
    out = {}

    def slab(u):
        return torch.as_tensor(part.to_shards(np.asarray(u))[rank])

    def gathered(x):
        return part.from_shards(comm.all_gather(x).numpy())

    op = DistAdaptivePoisson(part, comm)
    u = _probe(space.n_dofs)
    out["y"] = gathered(op.vmult(slab(u)))
    out["y_a"] = gathered(DistAdaptivePoisson(part, comm, a=_coef).vmult(slab(u)))
    b = slab(assemble_rhs_adaptive(space, 1.0).numpy())
    x, info = solve_cg_merged_dist_adaptive(op, b, _control())
    out.update(x=gathered(x), it=int(info["n_iterations"]))
    out["eta"] = estimate_gradient_recovery_dist(part, comm, x)
    mg = DistAdaptiveMultigrid(part, comm)
    out["z"] = gathered(mg.vcycle(slab(u)))
    x, info = solve_cg_mg_dist_adaptive(mg, b, _control())
    out.update(x_mg=gathered(x), it_mg=int(info["n_iterations"]), n_levels=mg.n_levels)
    # the transfers: prolongation against the single-device one, and
    # <P u_c, v_f> = <u_c, R v_f> over the ranks
    adj, prol = [], []
    for k in range(mg.n_levels - 1):
        pc, pf = mg.parts[k + 1], mg.parts[k]
        uc = np.random.default_rng(10 + k).standard_normal(pc.space.n_dofs)
        vf = np.random.default_rng(20 + k).standard_normal(pf.space.n_dofs)
        uc_sub = np.where(pc.space.constrained_mask_np, 0.0, uc)  # R zeroes the coarse constrained rows
        uc_s, vf_s = torch.as_tensor(pc.to_shards(uc_sub)[rank]), torch.as_tensor(pf.to_shards(vf)[rank])
        adj.append((_dot(comm, mg._prolong(k, uc_s), vf_s), _dot(comm, uc_s, mg._restrict(k, vf_s))))
        prol.append(pf.from_shards(comm.all_gather(mg._prolong(k, torch.as_tensor(pc.to_shards(uc)[rank]))).numpy()))
    out.update(adjoint=adj, prolong=prol)
    return out


def _run_amr(rank, n, group):
    from deal_and_ceed_on_gpu_torch.parallel import amr_loop_distributed

    hist = amr_loop_distributed(pt.BrickMesh((2, 2, 2)), 2, n, precond="mg", device="cpu", group=group,
                                keep_solutions=False, **AMR_KW)
    return [{k: h[k] for k in ("n_cells", "n_dofs", "n_iterations", "eta", "n_shards")} for h in hist]


def _rank_main(rank, cases):
    import torch.distributed as dist

    torch.set_num_threads(1)  # eight ranks share the host's cores with the other test workers
    sizes = sorted({c[0] for c in cases.values()} | {N_RANKS})
    groups = {n: None if n == N_RANKS else dist.new_group(list(range(n))) for n in sizes}
    out = {}
    for name, (n, kind, p) in cases.items():
        if rank < n:
            out[name] = _run_case(rank, n, kind, p, groups[n])
    out["amr"] = _run_amr(rank, N_RANKS, None)
    return out


@contextlib.contextmanager
def _one_blas_thread():
    """One BLAS thread in each rank (the children inherit the environment):
    eight ranks whose BLAS pools each span the host's cores spin against
    each other (a 729 x 729 inverse took seconds)."""
    saved = {k: os.environ.get(k) for k in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    os.environ.update({k: "1" for k in saved})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def ranks():
    """What every rank returned (the gathered fields are the same on each)."""
    from deal_and_ceed_on_gpu_torch.parallel import spawn

    with _one_blas_thread():
        return spawn(_rank_main, N_RANKS, args=(CASES,), backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)


# ----------------------------- JAX references ----------------------------- #
_JAX = {}


def _jax_run(name):
    """The JAX distributed runs of a case on the global DoF numbering:
    vmults, merged CG, one V-cycle, MG-CG."""
    if name in _JAX:
        return _JAX[name]
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Ps

    from deal_and_ceed_on_gpu_tpu import ReductionControl
    from deal_and_ceed_on_gpu_tpu.adaptive import AdaptiveSpace as JSpace
    from deal_and_ceed_on_gpu_tpu.adaptive import assemble_rhs_adaptive as jrhs
    from deal_and_ceed_on_gpu_tpu.parallel.dist_adaptive import (AdaptivePartition, DistAdaptivePoisson,
                                                                 make_device_mesh_1d, solve_cg_merged_dist_adaptive)
    from deal_and_ceed_on_gpu_tpu.parallel.dist_adaptive_mg import DistAdaptiveMultigrid, solve_cg_mg_dist_adaptive

    n, kind, p = CASES[name]
    space = JSpace(_mesh(kind, jax=True), p)
    part = AdaptivePartition(space, n)
    dm = make_device_mesh_1d(n)
    u = jnp.asarray(part.to_shards(_probe(space.n_dofs)))
    out = {}
    for key, a in (("y", None), ("y_a", _coef)):
        dop = DistAdaptivePoisson(part, a=a)
        f = jax.jit(jax.shard_map(lambda v, *t, dop=dop: dop.vmult_local(v, *t), mesh=dm,
                                  in_specs=(Ps("shard"),) + dop.operand_specs(), out_specs=Ps("shard")))
        out[key] = part.from_shards(np.asarray(f(u, *dop.shard_operands)))
    ctl = ReductionControl(800, tolerance=0.0, reduction=1e-10)
    b = jnp.asarray(part.to_shards(np.asarray(jrhs(space, 1.0))))
    x, info = solve_cg_merged_dist_adaptive(DistAdaptivePoisson(part), b, ctl)
    out.update(x=part.from_shards(np.asarray(x)), it=int(info["n_iterations"]))
    mg = DistAdaptiveMultigrid(part)
    vc = jax.jit(jax.shard_map(lambda v, *o: mg.vcycle_local(v.reshape(-1), o).reshape(1, -1), mesh=dm,
                               in_specs=(Ps("shard"),) + mg.operand_specs, out_specs=Ps("shard")))
    out["z"] = part.from_shards(np.asarray(vc(u, *mg.operands)))
    x, info = solve_cg_mg_dist_adaptive(mg, b, ctl)
    out.update(x_mg=part.from_shards(np.asarray(x)), it_mg=int(info["n_iterations"]), n_levels=mg.n_levels)
    _JAX[name] = out
    return out


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("key", ["y", "y_a"])
def test_dist_adaptive_vmult_against_jax_and_single_device(ranks, name, key):
    """The distributed vmult, Poisson and with the Helmholtz value term
    ``a=``: the single-device port's and (``JAX_CASES``) the JAX
    distributed apply to 1e-12."""
    got = ranks[0][name][key]
    if name in JAX_CASES:
        _close(got, _jax_run(name)[key])
    n, kind, p = CASES[name]
    space = _space(kind, p)
    op = AdaptivePoissonOperator(space) if key == "y" else AdaptiveHelmholtzOperator(space, a=_coef)
    _close(got, op.vmult(torch.as_tensor(_probe(space.n_dofs))).numpy())


@pytest.mark.parametrize("name", JAX_CASES)
def test_dist_adaptive_cg_against_jax(ranks, name):
    """Merged CG: the JAX iterations (+-1) and solution (the dryrun's rtol
    1e-7, atol 1e-9)."""
    got, want = ranks[0][name], _jax_run(name)
    assert abs(got["it"] - want["it"]) <= 1, (got["it"], want["it"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("name", JAX_CASES)
def test_dist_adaptive_vcycle_against_jax(ranks, name):
    """One V-cycle of the same slab vector: JAX's to 1e-12, the same
    hierarchy."""
    got, want = ranks[0][name], _jax_run(name)
    assert got["n_levels"] == want["n_levels"]
    _close(got["z"], want["z"])


@pytest.mark.parametrize("name", JAX_CASES)
def test_dist_adaptive_mg_cg_against_jax(ranks, name):
    """MG-CG: the JAX iterations (+-1) and solution."""
    got, want = ranks[0][name], _jax_run(name)
    assert abs(got["it_mg"] - want["it_mg"]) <= 1, (got["it_mg"], want["it_mg"])
    np.testing.assert_allclose(got["x_mg"], want["x_mg"], rtol=1e-7, atol=1e-9)


_SINGLE = {}


def _single(name):
    """The single-device port on a case: merged CG, the V-cycle of the probe
    and MG-CG (``AdaptiveMultigrid``)."""
    if name not in _SINGLE:
        n, kind, p = CASES[name]
        space = _space(kind, p)
        op = AdaptivePoissonOperator(space)
        b = assemble_rhs_adaptive(space, 1.0)
        x, info = pt.solve_cg_merged(op.vmult, b, _control())
        mg = pt.solvers.AdaptiveMultigrid(space, fine_op=op)
        z = mg.vcycle(torch.as_tensor(_probe(space.n_dofs)))
        xm, im = pt.solve_cg(op.vmult, b, _control(), diag=mg.vcycle)
        _SINGLE[name] = dict(x=x.numpy(), it=int(info["n_iterations"]), z=z.numpy(), x_mg=xm.numpy(),
                             it_mg=int(im["n_iterations"]), n_levels=mg.n_levels)
    return _SINGLE[name]


@pytest.mark.parametrize("name", list(CASES))
def test_dist_adaptive_solves_against_single_device(ranks, name):
    """Merged CG and MG-CG: the single-device port's iterations (+-1) and
    solutions (rtol 1e-7, atol 1e-9); one V-cycle to 1e-12."""
    got, want = ranks[0][name], _single(name)
    assert abs(got["it"] - want["it"]) <= 1 and abs(got["it_mg"] - want["it_mg"]) <= 1
    np.testing.assert_allclose(got["x"], want["x"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got["x_mg"], want["x_mg"], rtol=1e-7, atol=1e-9)
    assert got["n_levels"] == want["n_levels"]
    _close(got["z"], want["z"])


@pytest.mark.parametrize("name", list(CASES))
def test_dist_restriction_is_the_transpose_of_the_prolongation(ranks, name):
    """<P u, v> = <u, R v> to 1e-13 on every level pair, over the ranks
    (``u`` zero on the coarse constrained rows, which R zeroes: the solve
    subspace)."""
    for lhs, rhs in ranks[0][name]["adjoint"]:
        assert abs(lhs - rhs) <= 1e-13 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.parametrize("name", list(CASES))
def test_dist_prolongation_equals_single_device(ranks, name):
    """The distributed prolongation of every level pair is the single-device
    ``AdaptiveTransfer.prolong`` to 1e-12."""
    from deal_and_ceed_on_gpu_torch.solvers.adaptive_mg import AdaptiveTransfer, adaptive_hierarchy

    n, kind, p = CASES[name]
    space = _space(kind, p)
    meshes, transfers = adaptive_hierarchy(space.mesh)
    spaces = [space] + [AdaptiveSpace(m, p, device="cpu") for m in meshes[1:]]
    for k, (src, pick) in enumerate(transfers):
        tr = AdaptiveTransfer(spaces[k + 1], spaces[k], src, pick)
        uc = np.random.default_rng(10 + k).standard_normal(spaces[k + 1].n_dofs)
        _close(ranks[0][name]["prolong"][k], tr.prolong(torch.as_tensor(uc)).numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_dist_estimator_equals_host(ranks, name):
    """The distributed ZZ indicators on the distributed solution equal the
    host estimator's on the same field (1e-10 relative), on every rank."""
    got = ranks[0][name]
    n, kind, p = CASES[name]
    space = _space(kind, p)
    want = estimate_gradient_recovery(space, AdaptivePoissonOperator(space), torch.as_tensor(got["x"]))
    np.testing.assert_allclose(got["eta"], want, rtol=1e-10, atol=1e-14 * want.max())
    for r in ranks[1:n]:
        assert np.array_equal(r[name]["eta"], got["eta"])


def test_amr_loop_distributed_against_jax_and_single_device(ranks):
    """The distributed AMR loop on 8 ranks (the JAX dryrun's check 16):
    cells [8, 36, 50] and DoFs as the single-device loop, iterations +-1,
    estimates to 1e-8 against JAX's distributed loop; the same history on
    every rank."""
    from deal_and_ceed_on_gpu_tpu import BrickMesh as JBrick
    from deal_and_ceed_on_gpu_tpu.parallel import amr_loop_distributed

    got = ranks[0]["amr"]
    assert all(r["amr"] == got for r in ranks)
    want = amr_loop_distributed(JBrick((2, 2, 2)), 2, N_RANKS, precond="mg", keep_solutions=False, **AMR_KW)
    single = pt.adaptive.amr_loop(pt.BrickMesh((2, 2, 2)), 2, precond="mg", device="cpu", **AMR_KW)
    assert [h["n_cells"] for h in got] == [8, 36, 50]
    assert [h["n_cells"] for h in got] == [h["n_cells"] for h in want] == [h["n_cells"] for h in single]
    assert [h["n_dofs"] for h in got] == [h["n_dofs"] for h in want] == [h["n_dofs"] for h in single]
    for g, w in zip(got, want):
        assert abs(g["n_iterations"] - w["n_iterations"]) <= 1 and g["n_shards"] == N_RANKS
        np.testing.assert_allclose(g["eta"], w["eta"], rtol=1e-8)
