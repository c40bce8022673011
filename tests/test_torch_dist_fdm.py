"""The distributed FDM (``parallel/dist_fdm.py``) on spawned gloo CPU ranks,
against the JAX package's ``DistFDM`` under ``shard_map`` on the 8 virtual
CPU devices (``tests/conftest.py``) and the port's single-device
``FDMSolver``; and the collectives it needs (``ShardComm.all_to_all`` over
a rank's line, ``all_gather``).

One spawn of 8 ranks runs every case (a module fixture); a case on fewer
ranks runs on a subgroup. Covered: 2x1, 2x2, 4x2 (the JAX dryrun's check
17), 8x1 and a ragged 4x2 with dead elements, GLL and Gauss rules, a
graded brick; FDM-preconditioned CG on Helmholtz; the bp5 driver's
distributed ``fdm-direct``. Tolerances: direct solves 1e-12 (the JAX
test's), iterations equal, solutions 1e-10."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import assemble_rhs
from deal_and_ceed_on_gpu_torch.parallel import BlockPartition
from deal_and_ceed_on_gpu_torch.solvers.fdm import FDMSolver

N_RANKS = 8
SPAWN_TIMEOUT = 120.0
DRIVER_CYCLE = 6


def _graded():
    bz = np.cumsum(np.r_[0, 0.7 ** np.arange(6)[::-1]])
    return pt.BrickMesh.graded(np.linspace(0, 1, 4), np.linspace(0, 1.5, 3), bz / bz[-1])


# name -> ((pz, py), mesh, p, rule, what runs)
CASES = {
    "gll_2x1": ((2, 1), (3, 4, 5), 3, "gauss_lobatto", {}),
    "gll_2x2": ((2, 2), (3, 4, 5), 3, "gauss_lobatto", {}),
    "ragged_4x2": ((4, 2), (3, 4, 5), 3, "gauss_lobatto", {}),
    "slab_8x1": ((8, 1), (3, 4, 5), 3, "gauss_lobatto", {}),
    "dryrun_4x2": ((4, 2), (4, 8, 16), 2, "gauss_lobatto", {}),
    "gauss_2x2": ((2, 2), (4, 4, 4), 2, "gauss", {"pcg": True}),
    "graded_2x2": ((2, 2), "graded", 2, "gauss_lobatto", {}),
}


def _mesh(spec):
    return _graded() if spec == "graded" else pt.BrickMesh(spec)


def _rhs(mesh, p, rule):
    space = pt.FESpace.create(mesh, p, rule=rule, dtype=torch.float64, device="cpu")
    return space, assemble_rhs(space, lambda x: np.sin(3 * x[..., 0]) + x[..., 2])


def _control():
    return pt.ReductionControl(100, tolerance=0.0, reduction=1e-10)


def _run_case(rank, shards, mesh_spec, p, rule, spec, group):
    from deal_and_ceed_on_gpu_torch.parallel import DistFDM, DistOperator, ShardComm, solve_cg_fdm_dist

    mesh = _mesh(mesh_spec)
    part = BlockPartition(mesh, p, *shards)
    comm = ShardComm(part, "cpu", group)
    space, b = _rhs(mesh, p, rule)
    b_loc = torch.as_tensor(part.block(b.numpy().reshape(space.grid_shape), rank))
    fdm = DistFDM(part, comm, torch.float64, rule=rule)
    x = fdm.solve_direct(b_loc)
    out = {"x": comm.gather_blocks(x), "coherent": comm.shared_planes_equal(x)}
    if spec.get("pcg"):
        op = DistOperator(part, comm, pt.HelmholtzOperator, torch.float64, backend="structured", rule=rule)
        bh = torch.as_tensor(part.block(assemble_rhs(space, 1.0).numpy().reshape(space.grid_shape), rank))
        xh, info = solve_cg_fdm_dist(fdm, op, bh, _control())
        out.update(x_pcg=comm.gather_blocks(xh), it_pcg=int(info["n_iterations"]))
    return out


def _run_collectives(rank, group):
    """all_to_all over both lines of a 4x2 partition and all_gather
    over the group: each chunk labelled by its sender and receiver."""
    from deal_and_ceed_on_gpu_torch.parallel import ShardComm

    part = BlockPartition(pt.BrickMesh((2, 2, 4)), 1, 4, 2)
    comm = ShardComm(part, "cpu", group)
    out = {}
    for axis in (0, 1):
        line = comm.line(axis)
        got = comm.all_to_all(axis, [torch.tensor([float(rank), float(k)]) for k in range(len(line))])
        out[axis] = (line, [g.tolist() for g in got])
    out["gather"] = comm.all_gather(torch.tensor([rank, 10.0 * rank])).tolist()
    return out


def _run_driver(rank, group):
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import BP5Config, run_cycle_distributed
    from deal_and_ceed_on_gpu_torch.parallel import ShardComm

    part = BlockPartition(pt.BrickMesh.bp5_cycle(DRIVER_CYCLE), 5, 2, 2)
    comm = ShardComm(part, "cpu", group)
    cfg = BP5Config(dtype="float64", n_repetitions=1, device="cpu", modes=("fdm-direct",))
    return run_cycle_distributed(DRIVER_CYCLE, 2, 2, cfg, comm=comm)


def _rank_main(rank, cases):
    import torch.distributed as dist

    torch.set_num_threads(1)  # eight ranks share the host's cores with the other test workers
    sizes = sorted({s[0][0] * s[0][1] for s in cases.values()} | {4, N_RANKS})
    groups = {n: None if n == N_RANKS else dist.new_group(list(range(n))) for n in sizes}
    out = {}
    for name, (shards, mesh_spec, p, rule, spec) in cases.items():
        n = shards[0] * shards[1]
        if rank < n:
            out[name] = _run_case(rank, shards, mesh_spec, p, rule, spec, groups[n])
    out["collectives"] = _run_collectives(rank, groups[N_RANKS])
    if rank < 4:
        out["driver"] = _run_driver(rank, groups[4])
    return out


@pytest.fixture(scope="module")
def ranks():
    """What rank 0 returned (its gathers hold every block), and every rank's
    collectives."""
    from deal_and_ceed_on_gpu_torch.parallel import spawn

    res = spawn(_rank_main, N_RANKS, args=(CASES,), backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)
    return {**res[0], "collectives": [r["collectives"] for r in res]}


# ----------------------------- JAX references ----------------------------- #
_JAX = {}


def _jax_run(name):
    """The JAX distributed FDM of a case: the direct solve (and the
    FDM-preconditioned Helmholtz CG) on the global grid."""
    if name in _JAX:
        return _JAX[name]
    import jax.numpy as jnp

    from deal_and_ceed_on_gpu_tpu import BrickMesh as JMesh
    from deal_and_ceed_on_gpu_tpu import ReductionControl
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator
    from deal_and_ceed_on_gpu_tpu.parallel import BlockPartition as JPart
    from deal_and_ceed_on_gpu_tpu.parallel import DistFDM, DistOperator, make_device_mesh, solve_cg_fdm_dist

    (pz, py), mesh_spec, p, rule, spec = CASES[name]
    mesh = _mesh(mesh_spec)
    jmesh = JMesh(mesh.n_elements, mesh.lower, mesh.upper, widths=mesh.widths)
    part = JPart(jmesh, p, pz=pz, py=py)
    dm = make_device_mesh(pz, py)
    space, b = _rhs(mesh, p, rule)
    dfdm = DistFDM(part, dtype=jnp.float64, rule=rule)
    x = dfdm.solve_direct(jnp.asarray(part.to_blocks(b.numpy().reshape(space.grid_shape))), mesh=dm)
    out = {"x": part.from_blocks(np.asarray(x))}
    if spec.get("pcg"):
        dop = DistOperator(part, HelmholtzOperator, dtype=jnp.float64, backend="structured", rule=rule)
        bh = assemble_rhs(space, 1.0).numpy().reshape(space.grid_shape)
        xh, info = solve_cg_fdm_dist(dfdm, dop, jnp.asarray(part.to_blocks(bh)),
                                     ReductionControl(100, tolerance=0.0, reduction=1e-10), mesh=dm)
        out.update(x_pcg=part.from_blocks(np.asarray(xh)), it_pcg=int(info["n_iterations"]))
    _JAX[name] = out
    return out


def _assemble(name, blocks):
    shards, mesh_spec, p, _, _ = CASES[name]
    return BlockPartition(_mesh(mesh_spec), p, *shards).assemble(blocks)


@pytest.mark.parametrize("name", list(CASES))
def test_dist_fdm_direct_against_jax_and_single_device(ranks, name):
    """The direct solve equals the JAX distributed one and the single-device
    ``FDMSolver`` to 1e-12, and solves the system (true residual on the
    single-device operator below 1e-11)."""
    _, mesh_spec, p, rule, _ = CASES[name]
    x = _assemble(name, ranks[name]["x"])
    want = _jax_run(name)["x"]
    np.testing.assert_allclose(x, want, rtol=1e-12, atol=1e-14)
    space, b = _rhs(_mesh(mesh_spec), p, rule)
    x_ref = FDMSolver(space).solve(b).numpy().reshape(x.shape)
    np.testing.assert_allclose(x, x_ref, rtol=1e-12, atol=1e-14)
    op = pt.PoissonOperator(space, backend="separable" if rule == "gauss_lobatto" else "structured")
    xt = torch.as_tensor(x.reshape(-1))
    assert float(torch.linalg.vector_norm(b - op.vmult(xt)) / torch.linalg.vector_norm(b)) < 1e-11


@pytest.mark.parametrize("name", list(CASES))
def test_dist_fdm_ghost_planes_are_the_owners(ranks, name):
    """The refilled ghost planes (y, then z with the corner line) hold the
    owner's bits."""
    assert ranks[name]["coherent"]


def test_dist_fdm_preconditions_helmholtz_as_jax(ranks):
    """FDM-preconditioned distributed CG on the variable-coefficient
    Helmholtz operator: the JAX iterations, the JAX solution to 1e-10, and
    the single-device FDM-CG's iterations."""
    got, want = ranks["gauss_2x2"], _jax_run("gauss_2x2")
    assert got["it_pcg"] == want["it_pcg"], (got["it_pcg"], want["it_pcg"])
    x = _assemble("gauss_2x2", got["x_pcg"])
    np.testing.assert_allclose(x, want["x_pcg"], rtol=0, atol=1e-10 * np.abs(want["x_pcg"]).max())
    space = pt.FESpace.create(pt.BrickMesh((4, 4, 4)), 2, rule="gauss", dtype=torch.float64, device="cpu")
    op = pt.HelmholtzOperator(space, backend="structured")
    _, info = pt.solve_cg(op.vmult, assemble_rhs(space, 1.0), _control(), diag=FDMSolver(space).apply)
    assert got["it_pcg"] == int(info["n_iterations"])


@pytest.mark.parametrize("axis", [0, 1])
def test_all_to_all_over_the_lines(ranks, axis):
    """Chunk k of a rank reaches the k-th rank of its line; what comes back
    is in line order, from the ranks of this rank's line."""
    for rank, res in enumerate(ranks["collectives"]):
        line, got = res[axis]
        assert rank in line
        pos = line.index(rank)
        assert got == [[float(src), float(pos)] for src in line]


def test_all_gather_in_rank_order(ranks):
    for res in ranks["collectives"]:
        assert res["gather"] == [[r, 10.0 * r] for r in range(N_RANKS)]


def test_driver_fdm_direct_on_2x2_equals_single_device(ranks):
    """bp5's distributed ``fdm-direct`` (2 x 2 ranks): a true residual at
    roundoff, the single-device fdm-direct's L2 norm to 1e-10."""
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import BP5Config, run_cycle

    got = ranks["driver"]
    cfg = BP5Config(dtype="float64", n_repetitions=1, device="cpu", modes=("fdm-direct",))
    want = run_cycle(DRIVER_CYCLE, cfg)
    assert got["true_rel_res"]["fdm-direct"] < 1e-11 and got["finite"]["fdm-direct"] and got["coherent"]
    np.testing.assert_allclose(got["l2_norm"], want["l2_norm"], rtol=1e-10)


@pytest.mark.parametrize("bad", ["x_partitioned", "mapped"])
def test_dist_fdm_refuses_what_it_cannot_transpose(bad):
    if bad == "x_partitioned":
        part = BlockPartition(pt.BrickMesh((4, 2, 2)), 2, 1, 1, 2)
    else:
        part = BlockPartition(pt.BrickMesh((2, 2, 2)).deform(*pt.sine_map(0.05)), 2, 2)
    from deal_and_ceed_on_gpu_torch.parallel import DistFDM

    with pytest.raises(ValueError):
        DistFDM(part, None)


def test_driver_shards_fdm_direct_raises_without_a_card(monkeypatch):
    """``--shards 2x2 --dist-backend gloo --modes fdm-direct`` with the
    default device and no card raises before it starts a rank."""
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--cycle-min", "6", "--cycle-max", "6", "--shards", "2x2", "--dist-backend", "gloo",
              "--modes", "fdm-direct", "--dtype", "float64"])
