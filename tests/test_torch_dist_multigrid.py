"""The distributed geometric multigrid (``parallel/dist_multigrid.py``) on
spawned gloo CPU ranks, against the JAX package's ``DistMultigrid`` under
``shard_map`` on the 8 virtual CPU devices (``tests/conftest.py``) and the
port's single-device ``Multigrid``.

One spawn of 8 ranks runs every case (a module fixture); a case on fewer
ranks runs on a subgroup. Covered: the JAX dryrun's checks 10 and 11 (4x2
on (4, 8, 16) and the 3-D 2x2x2 on (8, 8, 8), p = 2), a graded brick on
4x2, a Gauss rule, uneven extents with dead elements, the explicit
``separable`` levels, Helmholtz with a non-default ``coefficient_fn`` under
``backend="auto"``. The levels run on the fine operator's kernel's plain
version (K1 in shard mode on GLL ``pz x py``, K4 on Gauss and 2x2x2,
``structured`` on the graded brick). Tolerances: one V-cycle 1e-12
against JAX, MG-CG iterations equal to JAX's, solutions 1e-9."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import assemble_rhs
from deal_and_ceed_on_gpu_torch.parallel import BlockPartition

N_RANKS = 8
SPAWN_TIMEOUT = 120.0
P = 2


def _graded():
    bz = np.cumsum(np.r_[0, 0.7 ** np.arange(8)[::-1]])
    return pt.BrickMesh.graded(np.linspace(0, 1, 5), np.linspace(0, 1, 5), bz / bz[-1])


# name -> ((pz, py, px), mesh, rule, backend, coarse_max_dofs, the JAX backend, operator)
CASES = {
    "dryrun_4x2": ((4, 2, 1), (4, 8, 16), "gauss_lobatto", "auto", 300, "separable", "poisson"),
    "dryrun_2x2x2": ((2, 2, 2), (8, 8, 8), "gauss_lobatto", "auto", 500, "separable", "poisson"),
    "graded_4x2": ((4, 2, 1), "graded", "gauss_lobatto", "auto", 500, "structured", "poisson"),
    "gauss_2x2": ((2, 2, 1), (4, 4, 8), "gauss", "auto", 500, "structured", "poisson"),
    "uneven_2x2": ((2, 2, 1), (4, 4, 12), "gauss_lobatto", "auto", 500, "separable", "poisson"),
    "separable_2x1": ((2, 1, 1), (4, 8, 8), "gauss_lobatto", "separable", 500, "separable", "poisson"),
    "helmholtz_2x2": ((2, 2, 1), (4, 4, 8), "gauss_lobatto", "auto", 500, "structured", "helmholtz"),
}
LEVEL_CLASSES = {"dryrun_4x2": "DistStencilOperator", "dryrun_2x2x2": "DistOperator/general",
                 "graded_4x2": "DistOperator/structured", "gauss_2x2": "DistOperator/general",
                 "uneven_2x2": "DistStencilOperator", "separable_2x1": "DistOperator/separable",
                 "helmholtz_2x2": "DistStencilOperator"}


def _coef(X):
    """A Helmholtz coefficient other than the step-64 default."""
    return 1.0 + X[..., 0] ** 2 + 0.5 * X[..., 2]


def _op_args(op, jax=False):
    """(op_cls, op_kwargs) of a case's operator, the port's or JAX's."""
    if op == "poisson":
        return (None, {}) if jax else (pt.PoissonOperator, {})
    if jax:
        from deal_and_ceed_on_gpu_tpu import HelmholtzOperator as JHelmholtz

        return JHelmholtz, {"coefficient_fn": _coef}
    return pt.HelmholtzOperator, {"coefficient_fn": _coef}


def _mesh(spec):
    return _graded() if spec == "graded" else pt.BrickMesh(spec)


def _control():
    return pt.ReductionControl(60, tolerance=0.0, reduction=1e-10)


def _global(mesh, rule):
    """The global space, right-hand side and V-cycle probe (constrained rows
    zero) of a case, host float64."""
    space = pt.FESpace.create(mesh, P, rule=rule, dtype=torch.float64, device="cpu")
    b = assemble_rhs(space, 1.0).numpy().reshape(space.grid_shape)
    r = np.random.default_rng(7).standard_normal(space.grid_shape)
    r[space.dirichlet_mask.numpy().reshape(space.grid_shape)] = 0.0
    return space, b, r


def _run_case(rank, shards, mesh_spec, rule, backend, cmax, op, group):
    from deal_and_ceed_on_gpu_torch.parallel import DistMultigrid, ShardComm, solve_cg_mg_dist

    mesh = _mesh(mesh_spec)
    part = BlockPartition(mesh, P, *shards)
    comm = ShardComm(part, "cpu", group)
    _, b, r = _global(mesh, rule)
    op_cls, op_kwargs = _op_args(op)
    mg = DistMultigrid(part, comm, op_cls, dtype=torch.float64, backend=backend, rule=rule, coarse_max_dofs=cmax,
                       **op_kwargs)
    z = mg.vcycle(torch.as_tensor(part.block(r, rank)))
    x, info = solve_cg_mg_dist(mg, torch.as_tensor(part.block(b, rank)), _control())
    kinds = [type(op).__name__ + ("" if not hasattr(op, "backend") else f"/{op.backend}") for op in mg.dist_ops]
    return {"z": comm.gather_blocks(z), "z_coherent": comm.shared_planes_equal(z), "x": comm.gather_blocks(x),
            "it": int(info["n_iterations"]), "coherent": comm.shared_planes_equal(x), "n_levels": mg.n_levels,
            "kinds": kinds}


def _rank_main(rank, cases):
    import torch.distributed as dist

    torch.set_num_threads(1)  # eight ranks share the host's cores with the other test workers
    sizes = sorted({int(np.prod(c[0])) for c in cases.values()} | {N_RANKS})
    groups = {n: None if n == N_RANKS else dist.new_group(list(range(n))) for n in sizes}
    out = {}
    for name, (shards, mesh_spec, rule, backend, cmax, _, op) in cases.items():
        n = int(np.prod(shards))
        if rank < n:
            out[name] = _run_case(rank, shards, mesh_spec, rule, backend, cmax, op, groups[n])
    return out


@pytest.fixture(scope="module")
def ranks():
    """What rank 0 of each case returned (its gathers hold every block)."""
    from deal_and_ceed_on_gpu_torch.parallel import spawn

    return spawn(_rank_main, N_RANKS, args=(CASES,), backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)[0]


# ----------------------------- JAX references ----------------------------- #
_JAX = {}


def _jax_run(name):
    """The JAX distributed multigrid of a case: one V-cycle of the probe and
    the MG-CG solve, on the global grid."""
    if name in _JAX:
        return _JAX[name]
    import jax
    import jax.numpy as jnp

    from deal_and_ceed_on_gpu_tpu import BrickMesh as JMesh
    from deal_and_ceed_on_gpu_tpu import ReductionControl
    from deal_and_ceed_on_gpu_tpu.parallel import BlockPartition as JPart
    from deal_and_ceed_on_gpu_tpu.parallel import DistMultigrid, make_device_mesh, solve_cg_mg_dist

    (pz, py, px), mesh_spec, rule, _, cmax, jbackend, op = CASES[name]
    mesh = _mesh(mesh_spec)
    part = JPart(JMesh(mesh.n_elements, mesh.lower, mesh.upper, widths=mesh.widths), P, pz=pz, py=py, px=px)
    dm = make_device_mesh(pz, py, px=px)
    _, b, r = _global(mesh, rule)
    op_cls, op_kwargs = _op_args(op, jax=True)
    if op_cls is not None:
        op_kwargs["op_cls"] = op_cls
    dmg = DistMultigrid(part, dtype=jnp.float64, backend=jbackend, rule=rule, coarse_max_dofs=cmax, **op_kwargs)
    vc = jax.jit(jax.shard_map(lambda u, *o: dmg.vcycle_local(u, o), mesh=dm,
                               in_specs=(dmg.grid_spec,) + dmg.operand_specs, out_specs=dmg.grid_spec))
    z = part.from_blocks(np.asarray(vc(jnp.asarray(part.to_blocks(r)), *dmg.operands)))
    x, info = solve_cg_mg_dist(dmg, jnp.asarray(part.to_blocks(b)), ReductionControl(60, tolerance=0.0,
                                                                                       reduction=1e-10), mesh=dm)
    _JAX[name] = {"z": z, "x": part.from_blocks(np.asarray(x)), "it": int(info["n_iterations"]),
                  "n_levels": dmg.n_levels}
    return _JAX[name]


def _assemble(name, blocks):
    shards, mesh_spec = CASES[name][:2]
    return BlockPartition(_mesh(mesh_spec), P, *shards).assemble(blocks)


@pytest.mark.parametrize("name", list(CASES))
def test_dist_vcycle_against_jax(ranks, name):
    """One V-cycle of the same residual: the JAX distributed V-cycle's
    hierarchy and result to 1e-12, shared planes bitwise equal."""
    got, want = ranks[name], _jax_run(name)
    assert got["n_levels"] == want["n_levels"]
    z = _assemble(name, got["z"])
    np.testing.assert_allclose(z, want["z"], rtol=0, atol=1e-12 * np.abs(want["z"]).max())
    assert got["z_coherent"]


@pytest.mark.parametrize("name", list(CASES))
def test_dist_mg_cg_against_jax(ranks, name):
    """MG-preconditioned CG: the JAX iterations and its solution to 1e-9."""
    got, want = ranks[name], _jax_run(name)
    assert got["it"] == want["it"], (got["it"], want["it"])
    x = _assemble(name, got["x"])
    np.testing.assert_allclose(x, want["x"], rtol=0, atol=1e-9 * np.abs(want["x"]).max())
    assert got["coherent"]


@pytest.mark.parametrize("name", ["dryrun_4x2", "dryrun_2x2x2", "separable_2x1"])
def test_dist_mg_cg_equals_single_device(ranks, name):
    """Where the block-aligned hierarchy is the single-device one, the
    iterations and the solution (1e-9) of the single-device MG-CG."""
    _, mesh_spec, rule, _, cmax, _, _ = CASES[name]
    space, b, _ = _global(_mesh(mesh_spec), rule)
    op = pt.PoissonOperator(space, backend="separable")
    mg = pt.solvers.Multigrid(space, coarse_max_dofs=cmax)
    x_ref, info = pt.solve_cg(op.vmult, torch.as_tensor(b.reshape(-1)), _control(), diag=mg.vcycle)
    got = ranks[name]
    assert got["n_levels"] == mg.n_levels and got["it"] == int(info["n_iterations"])
    x = _assemble(name, got["x"]).reshape(-1)
    np.testing.assert_allclose(x, x_ref.numpy(), rtol=0, atol=1e-9 * float(x_ref.abs().max()))


@pytest.mark.parametrize("name", list(CASES))
def test_levels_run_on_the_fine_operators_kernel(ranks, name):
    """``backend="auto"``: K1 in shard mode on a uniform GLL ``pz x py``
    brick, K4 on Gauss and on an x-partitioned brick, ``structured`` on a
    graded one; every smoothing level on it."""
    kinds = ranks[name]["kinds"]
    assert kinds == [LEVEL_CLASSES[name]] * (ranks[name]["n_levels"] - 1), kinds


@pytest.mark.parametrize("shards,mesh,rule,op,want", [
    ((4, 2, 1), (4, 8, 16), "gauss_lobatto", "poisson", "stencil"),
    ((2, 2, 1), (4, 4, 8), "gauss_lobatto", "helmholtz", "stencil"),
    ((2, 2, 2), (8, 8, 8), "gauss_lobatto", "poisson", "general"),
    ((2, 2, 1), (4, 4, 8), "gauss", "poisson", "general"),
    ((2, 2, 1), (4, 4, 8), "gauss", "helmholtz", "structured"),
    ((4, 2, 1), "graded", "gauss_lobatto", "poisson", "structured"),
])
def test_level_backend_follows_the_kernel(shards, mesh, rule, op, want):
    from deal_and_ceed_on_gpu_torch.parallel.dist_multigrid import level_backend

    part = BlockPartition(_mesh(mesh), P, *shards)
    cls = pt.HelmholtzOperator if op == "helmholtz" else pt.PoissonOperator
    assert level_backend(part, cls, rule) == want
    assert level_backend(part, cls, rule, "separable") == "separable"


def test_level_backend_leaves_the_stencil_off_collocation():
    """K1 is collocated: a GLL rule with more points than nodes puts the
    levels on K4."""
    from deal_and_ceed_on_gpu_torch.parallel.dist_multigrid import level_backend

    part = BlockPartition(pt.BrickMesh((4, 4, 8)), P, 2, 2)
    assert level_backend(part, pt.PoissonOperator, "gauss_lobatto", n_q=P + 1) == "stencil"
    assert level_backend(part, pt.PoissonOperator, "gauss_lobatto", n_q=P + 2) == "general"


@pytest.mark.parametrize("mesh,shards,match", [
    ((3, 3, 3), (2, 1, 1), "cannot build a block-aligned hierarchy"),
    ((54, 54, 2), (1, 1, 1), "too early for a dense coarse solve"),
])
def test_hierarchy_guard_refuses_as_jax(mesh, shards, match):
    """The JAX hierarchy guard and its messages: no block-aligned level, or
    a coarsest level too large for the dense solve."""
    from deal_and_ceed_on_gpu_torch.parallel import DistMultigrid

    with pytest.raises(ValueError, match=match):
        DistMultigrid(BlockPartition(pt.BrickMesh(mesh), P, *shards), None, coarse_max_dofs=300)
