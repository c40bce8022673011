"""The distributed port on spawned gloo CPU ranks, against the JAX package's
distributed runs at the same partitions (8 virtual CPU devices,
``tests/conftest.py``) and the port's single-device solves.

One spawn of 8 ranks runs every case (a module fixture); a case on fewer
ranks runs on a subgroup. Covered: 2x1, 2x2, ragged 3x1 (a vector BP), a
4x2 with a dead block and the 3-D 2x2x2; Poisson and Helmholtz on the
cell-loop backends, K4's ``general``, the overlapped ``separable``; the K1
stencil with the overlapped exchange on and off (shared planes bitwise
equal on both sharers); bf16-stored vectors inside iterative refinement to a
true f64 residual of 1e-10; K2 (``dist_banded``), also with bf16 vectors;
the bp5 driver's ``run_cycle_distributed`` (with ``--write-solution``: one
.vtr piece a rank and a .pvtr master, byte-identical to the JAX writer's)
and its lambda estimate on the distributed stencil. Tolerances: applies 1e-12 (f64), iterations +-1,
solutions 1e-10."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import assemble_rhs
from deal_and_ceed_on_gpu_torch.ops import banded as bd
from deal_and_ceed_on_gpu_torch.parallel import BlockPartition

N_RANKS = 8
P = 2
SPAWN_TIMEOUT = 120.0
DRIVER_ITERATIONS = 50  # the driver's cap: its solves, vmult chain and lambda estimate stay short

# name -> (ranks, (pz, py, px), mesh elements, what runs)
CASES = {
    "structured_2x1": (2, (2, 1, 1), (2, 3, 5), dict(op="poisson", backend="structured", rule="gauss", plain=True,
                                                     jacobi=True)),
    "helmholtz_2x2": (4, (2, 2, 1), (2, 5, 5), dict(op="helmholtz", backend="structured", rule="gauss")),
    "vector_3x1": (3, (3, 1, 1), (2, 3, 5), dict(op="poisson", backend="structured", rule="gauss", nc=3)),
    "general_2x2": (4, (2, 2, 1), (2, 5, 5), dict(op="poisson", backend="general", rule="gauss", n_q=P + 2)),
    "separable_2x2": (4, (2, 2, 1), (2, 5, 5), dict(op="poisson", backend="separable", rule="gauss_lobatto")),
    "stencil_overlap_2x2": (4, (2, 2, 1), (2, 5, 5), dict(op="stencil", overlap=True, plain=True)),
    "stencil_halo_2x2": (4, (2, 2, 1), (2, 5, 5), dict(op="stencil", overlap=False)),
    "stencil_helmholtz_4x2": (8, (4, 2, 1), (2, 5, 9), dict(op="stencil", value=True, overlap=True)),
    "stencil_bf16_ir_2x2": (4, (2, 2, 1), (3, 3, 4), dict(op="stencil-ir")),
    "banded_2x2": (4, (2, 2, 1), (2, 5, 5), dict(op="banded", kind="stiffness")),
    "banded_mass_nc3_3x1": (3, (3, 1, 1), (2, 3, 5), dict(op="banded", kind="mass", nc=3)),
    "banded_bf16_2x2": (4, (2, 2, 1), (2, 5, 5), dict(op="banded-bf16", kind="stiffness")),
    "lambda_2x2": (4, (2, 2, 1), (2, 5, 5), dict(op="lambda")),
    "structured_2x2x2": (8, (2, 2, 2), (3, 3, 3), dict(op="poisson", backend="structured", rule="gauss")),
    "driver_2x2": (4, (2, 2, 1), None, dict(op="driver", cycle=5)),
}


def _control():
    return pt.ReductionControl(200, tolerance=0.0, reduction=1e-10)


def _dist_op(part, comm, spec):
    from deal_and_ceed_on_gpu_torch.parallel import DistBandedOperator, DistOperator, DistStencilOperator

    op = spec["op"]
    if op == "stencil":
        return DistStencilOperator(part, comm, torch.float64, operator="helmholtz" if spec.get("value") else "poisson",
                                   overlap=spec["overlap"])
    if op == "banded":
        return DistBandedOperator(part, comm, torch.float64, kind=spec["kind"])
    cls = pt.HelmholtzOperator if op == "helmholtz" else pt.PoissonOperator
    return DistOperator(part, comm, cls, torch.float64, backend=spec["backend"], rule=spec["rule"],
                        n_q=spec.get("n_q"))


def _space_args(spec):
    """(n_q, rule) of the global space of a case."""
    if spec["op"] in ("stencil", "stencil-ir") or spec.get("rule") == "gauss_lobatto":
        return None, "gauss_lobatto"
    if spec["op"] == "banded":
        return P + 2, "gauss"
    return spec.get("n_q"), "gauss"


def _global_rhs(mesh, spec, nc):
    n_q, rule = _space_args(spec)
    space = pt.FESpace.create(mesh, P, n_q=n_q, rule=rule, dtype=torch.float64, device="cpu")
    b = assemble_rhs(space, 1.0).numpy().reshape(space.grid_shape)
    return b if nc == 1 else np.stack([(c + 1.0) * b for c in range(nc)])


def _probe(shape, nc):
    u = np.random.default_rng(11).standard_normal(shape)
    return u if nc == 1 else np.stack([u, 0.5 * u, -u])


def _block(part, g, rank, nc):
    if nc == 1:
        return torch.as_tensor(part.block(g, rank))
    return torch.as_tensor(np.stack([part.block(c, rank) for c in g]))


def _run_case(rank, ranks, shards, n_el, spec, group):
    from deal_and_ceed_on_gpu_torch.parallel import ShardComm, solve_cg_dist, solve_cg_merged_dist

    if spec["op"] == "driver":
        from deal_and_ceed_on_gpu_torch.drivers.bp5 import BP5Config, run_cycle_distributed

        part = BlockPartition(pt.BrickMesh.bp5_cycle(spec["cycle"]), 5, *shards)
        comm = ShardComm(part, "cpu", group)
        cfg = BP5Config(dtype="float64", n_iterations=DRIVER_ITERATIONS, n_repetitions=1, device="cpu")
        return run_cycle_distributed(spec["cycle"], shards[0], shards[1], cfg, shards[2], comm=comm,
                                     write_solution=spec.get("write_solution"))
    mesh = pt.BrickMesh(n_el)
    part = BlockPartition(mesh, P, *shards)
    comm = ShardComm(part, "cpu", group)
    if spec["op"] == "stencil-ir":
        return _run_ir(rank, part, comm)
    if spec["op"] == "banded-bf16":
        from deal_and_ceed_on_gpu_torch.parallel import DistBandedOperator

        op = DistBandedOperator(part, comm, torch.float32, kind=spec["kind"], stream_dtype=torch.bfloat16)
        u = _block(part, _probe(part.global_grid_shape, 1), rank, 1).to(torch.bfloat16)
        y = op.vmult(u)
        return {"y": comm.gather_blocks(y.double()), "dtype": str(y.dtype), "coherent": comm.shared_planes_equal(y)}
    if spec["op"] == "lambda":
        from deal_and_ceed_on_gpu_torch.drivers.bp5 import estimate_lambda_max
        from deal_and_ceed_on_gpu_torch.parallel import DistStencilOperator

        op = DistStencilOperator(part, comm, torch.float64)
        n = int(np.prod(part.global_grid_shape))
        lam = estimate_lambda_max(op, n, block=lambda g: part.block(g.reshape(part.global_grid_shape), rank),
                                  dot_weight=op.dot_weight, comm=comm)
        return {"lambda": lam}
    nc = spec.get("nc", 1)
    op = _dist_op(part, comm, spec)
    out = {"y": comm.gather_blocks(op.vmult(_block(part, _probe(part.global_grid_shape, nc), rank, nc)))}
    b = _block(part, _global_rhs(mesh, spec, nc), rank, nc)
    x, info = solve_cg_merged_dist(op, b, _control())
    out.update(x=comm.gather_blocks(x), it=int(info["n_iterations"]), coherent=comm.shared_planes_equal(x))
    if spec.get("plain"):
        x, info = solve_cg_dist(op, b, _control())
        out.update(x_plain=comm.gather_blocks(x), it_plain=int(info["n_iterations"]))
    if spec.get("jacobi"):
        x, info = solve_cg_merged_dist(op, b, _control(), diag_local=op.jacobi_blocks())
        out.update(x_jacobi=comm.gather_blocks(x), it_jacobi=int(info["n_iterations"]))
    return out


def _run_ir(rank, part, comm):
    """bf16-stored f32 stencil merged CG as the inner solve of iterative
    refinement, f64 residuals on the f64 distributed stencil, to a true
    relative residual of 1e-10 (the JAX dryrun's bf16 check)."""
    from deal_and_ceed_on_gpu_torch.parallel import DistStencilOperator, solve_cg_merged_dist

    op64 = DistStencilOperator(part, comm, torch.float64)
    op16 = DistStencilOperator(part, comm, torch.float32, stream_dtype=torch.bfloat16)
    w = op64.dot_weight
    b = _block(part, _global_rhs(part.mesh, {"op": "stencil"}, 1), rank, 1)

    def norm(v):
        return float(torch.sqrt(comm.allreduce_sum_(torch.dot((v * w).reshape(-1), v.reshape(-1)).reshape(1)))[0])

    inner = pt.ReductionControl(60, tolerance=0.0, reduction=3e-2, success_on_max_steps=True)
    bnorm, x, res, n_outer = norm(b), torch.zeros_like(b), 1.0, 0
    for _ in range(12):
        r = b - op64.vmult(x)
        res = norm(r) / bnorm
        if res <= 1e-10:
            break
        e, _ = solve_cg_merged_dist(op16, r, inner)
        x = x + e.to(torch.float64)
        n_outer += 1
    return {"x": comm.gather_blocks(x), "n_outer": n_outer, "res": res, "coherent": comm.shared_planes_equal(x)}


def _rank_main(rank, cases):
    """Every case on the ranks it needs (a subgroup of the first ones)."""
    import torch.distributed as dist

    torch.set_num_threads(1)  # eight ranks share the host's cores with the other test workers
    groups = {n: None if n == N_RANKS else dist.new_group(list(range(n))) for n in sorted({c[0] for c in cases.values()})}
    out = {}
    for name, (ranks, shards, n_el, spec) in cases.items():
        if rank < ranks:
            out[name] = _run_case(rank, ranks, shards, n_el, spec, groups[ranks])
    return out


@pytest.fixture(scope="module")
def pvtr_dir(tmp_path_factory):
    """Where the driver case writes its solution (``--write-solution``)."""
    return tmp_path_factory.mktemp("pvtr")


@pytest.fixture(scope="module")
def ranks(pvtr_dir):
    """What rank 0 of each case returned (its gathers hold every block)."""
    from deal_and_ceed_on_gpu_torch.parallel import spawn

    cases = dict(CASES)
    n, shards, n_el, spec = cases["driver_2x2"]
    cases["driver_2x2"] = (n, shards, n_el, dict(spec, write_solution=str(pvtr_dir / "bp5.pvtr")))
    return spawn(_rank_main, N_RANKS, args=(cases,), backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)[0]


# ----------------------------- JAX references ----------------------------- #
_JAX_RUNS = {}


def _jax_run(shards, n_el, spec):
    """``_jax_solve``, once per operator and partition: the halo and the
    overlapped stencil cases compute the same function, so they share the
    JAX overlapped run (with its plain CG where either case asks for it)."""
    key = (shards, n_el, tuple(sorted((k, v) for k, v in spec.items() if k not in ("overlap", "plain"))))
    if key not in _JAX_RUNS:
        plain = any(c[3].get("plain") for c in CASES.values() if c[1] == shards and c[2] == n_el
                    and c[3].get("op") == spec.get("op") and c[3].get("value") == spec.get("value"))
        _JAX_RUNS[key] = _jax_solve(shards, n_el, {**spec, "overlap": True, "plain": plain})
    return _JAX_RUNS[key]


def _jax_solve(shards, n_el, spec):
    """The JAX distributed run of a case: (A probe, x, iterations) on the
    global grid, the stencil on ``DistStencilOperator`` in interpret mode,
    K2 on ``DistBandedOperator``, the rest on ``DistOperator``."""
    import jax.numpy as jnp

    from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace, ReductionControl
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator, PoissonOperator
    from deal_and_ceed_on_gpu_tpu.parallel import (BlockPartition as JPart, DistOperator, make_device_mesh,
                                                   make_dist_vmult, solve_cg_dist, solve_cg_merged_dist)
    from deal_and_ceed_on_gpu_tpu.parallel.dist_banded import DistBandedOperator
    from deal_and_ceed_on_gpu_tpu.parallel.dist_pallas import (DistStencilOperator, make_dist_vmult_pallas,
                                                               solve_cg_dist_pallas, solve_cg_merged_dist_pallas)

    pz, py, px = shards
    mesh = BrickMesh(n_el)
    part = JPart(mesh, P, pz=pz, py=py, px=px)
    dm = make_device_mesh(pz, py, px=px)
    control = ReductionControl(200, tolerance=0.0, reduction=1e-10)
    nc = spec.get("nc", 1)
    b = _global_rhs(pt.BrickMesh(n_el), spec, nc)
    u = _probe(part.global_grid_shape, nc)
    out = {}
    if spec["op"] in ("stencil", "banded"):
        if spec["op"] == "stencil":
            dop = DistStencilOperator(part, dtype=jnp.float64, interpret=True, overlap=spec["overlap"],
                                      operator="helmholtz" if spec.get("value") else "poisson")
        else:
            dop = DistBandedOperator(part, dtype=jnp.float64, kind=spec["kind"], n_q=P + 2, interpret=True)
        if nc == 1:
            out["y"] = dop.from_padded_blocks(np.asarray(make_dist_vmult_pallas(dop, dm)(
                jnp.asarray(dop.to_padded_blocks(u)))))
            x, info = solve_cg_merged_dist_pallas(dop, jnp.asarray(dop.to_padded_blocks(b)), control, mesh=dm)
            out.update(x=dop.from_padded_blocks(np.asarray(x)), it=int(info["n_iterations"]))
            if spec.get("plain"):
                x, info = solve_cg_dist_pallas(dop, jnp.asarray(dop.to_padded_blocks(b)), control, mesh=dm)
                out.update(x_plain=dop.from_padded_blocks(np.asarray(x)), it_plain=int(info["n_iterations"]))
            return out
        # the JAX banded class is scalar: its components one at a time
        vm = make_dist_vmult_pallas(dop, dm)
        out["y"] = np.stack([dop.from_padded_blocks(np.asarray(vm(jnp.asarray(dop.to_padded_blocks(c))))) for c in u])
        return out
    cls = HelmholtzOperator if spec["op"] == "helmholtz" else PoissonOperator
    dop = DistOperator(part, cls, dtype=jnp.float64, backend="structured" if spec["backend"] == "general"
                       else spec["backend"], rule=spec["rule"], n_q=spec.get("n_q"), n_components=nc)
    out["y"] = part.from_blocks(np.asarray(make_dist_vmult(dop, dm)(jnp.asarray(part.to_blocks(u)))))
    x, info = solve_cg_merged_dist(dop, jnp.asarray(part.to_blocks(b)), control, mesh=dm)
    out.update(x=part.from_blocks(np.asarray(x)), it=int(info["n_iterations"]))
    if spec.get("plain"):
        x, info = solve_cg_dist(dop, jnp.asarray(part.to_blocks(b)), control, mesh=dm)
        out.update(x_plain=part.from_blocks(np.asarray(x)), it_plain=int(info["n_iterations"]))
    return out


def _assemble(shards, n_el, blocks):
    part = BlockPartition(pt.BrickMesh(n_el), P, *shards)
    if blocks[0].ndim == 4:
        return np.stack([part.assemble([b[c] for b in blocks]) for c in range(blocks[0].shape[0])])
    return part.assemble(blocks)


SOLVE_CASES = [k for k, v in CASES.items() if v[3]["op"] not in ("driver", "stencil-ir", "banded-bf16", "lambda")]


@pytest.mark.parametrize("name", SOLVE_CASES)
def test_dist_apply_and_solve_against_jax(ranks, name):
    _, shards, n_el, spec = CASES[name]
    got, want = ranks[name], _jax_run(shards, n_el, spec)
    y = _assemble(shards, n_el, got["y"])
    np.testing.assert_allclose(y, want["y"], rtol=0, atol=1e-12 * np.abs(want["y"]).max())
    if "x" not in want:
        return
    assert abs(got["it"] - want["it"]) <= 1, (got["it"], want["it"])
    x = _assemble(shards, n_el, got["x"])
    np.testing.assert_allclose(np.linalg.norm(x), np.linalg.norm(want["x"]), rtol=1e-10)
    np.testing.assert_allclose(x, want["x"], rtol=0, atol=1e-10 * np.abs(want["x"]).max())
    if spec.get("plain"):
        assert abs(got["it_plain"] - want["it_plain"]) <= 1
        xp = _assemble(shards, n_el, got["x_plain"])
        np.testing.assert_allclose(xp, want["x_plain"], rtol=0, atol=1e-10 * np.abs(want["x_plain"]).max())


@pytest.mark.parametrize("name", [k for k in SOLVE_CASES if CASES[k][3]["op"] in ("stencil", "separable", "banded")
                                  or CASES[k][3].get("backend") == "separable"])
def test_shared_planes_bitwise_equal(ranks, name):
    """The overlapped exchange (position-ordered sums) and the halo add keep
    every duplicated plane of the solution bitwise equal on its sharers."""
    assert ranks[name]["coherent"]


@pytest.mark.parametrize("name", ["structured_2x1", "stencil_overlap_2x2", "stencil_helmholtz_4x2", "banded_2x2"])
def test_dist_solution_equals_single_device(ranks, name):
    """The distributed solution is the single-device port's (same
    operator), to 1e-10."""
    _, shards, n_el, spec = CASES[name]
    n_q, rule = _space_args(spec)
    space = pt.FESpace.create(pt.BrickMesh(n_el), P, n_q=n_q, rule=rule, dtype=torch.float64, device="cpu")
    cls = pt.HelmholtzOperator if spec["op"] == "helmholtz" or spec.get("value") else pt.PoissonOperator
    op = cls(space, backend="separable" if rule == "gauss_lobatto" else "structured")
    x_ref, info = pt.solve_cg_merged(op.vmult, assemble_rhs(space, 1.0), _control())
    x = _assemble(shards, n_el, ranks[name]["x"]).reshape(-1)
    assert abs(ranks[name]["it"] - int(info["n_iterations"])) <= 1
    np.testing.assert_allclose(x, x_ref.numpy(), rtol=0, atol=1e-10 * float(x_ref.abs().max()))


def test_jacobi_blocks_precondition_as_on_one_device(ranks):
    """``DistOperator.jacobi_blocks`` as the merged CG's diagonal: the
    single-device Jacobi-preconditioned solve's iterations and solution."""
    _, shards, n_el, spec = CASES["structured_2x1"]
    space = pt.FESpace.create(pt.BrickMesh(n_el), P, rule="gauss", dtype=torch.float64, device="cpu")
    op = pt.PoissonOperator(space, backend="structured")
    x_ref, info = pt.solve_cg_merged(op.vmult, assemble_rhs(space, 1.0), _control(), diag=op.jacobi_preconditioner())
    got = ranks["structured_2x1"]
    assert abs(got["it_jacobi"] - int(info["n_iterations"])) <= 1
    x = _assemble(shards, n_el, got["x_jacobi"]).reshape(-1)
    np.testing.assert_allclose(x, x_ref.numpy(), rtol=0, atol=1e-10 * float(x_ref.abs().max()))


def test_bf16_streaming_ir_to_true_f64_residual(ranks):
    got = ranks["stencil_bf16_ir_2x2"]
    assert got["res"] <= 1e-10 and 1 <= got["n_outer"] <= 12 and got["coherent"]
    _, shards, n_el, _ = CASES["stencil_bf16_ir_2x2"]
    space = pt.FESpace.create(pt.BrickMesh(n_el), P, dtype=torch.float64, device="cpu")
    op = pt.PoissonOperator(space, backend="separable")
    b = assemble_rhs(space, 1.0)
    x = torch.as_tensor(_assemble(shards, n_el, got["x"]).reshape(-1))
    assert float(torch.linalg.vector_norm(b - op.vmult(x)) / torch.linalg.vector_norm(b)) <= 1e-10


def test_driver_run_cycle_distributed_equals_single_device(ranks):
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import BP5Config, run_cycle

    got = ranks["driver_2x2"][0] if isinstance(ranks["driver_2x2"], list) else ranks["driver_2x2"]
    cfg = BP5Config(dtype="float64", n_iterations=DRIVER_ITERATIONS, n_repetitions=1, device="cpu")
    want = run_cycle(CASES["driver_2x2"][3]["cycle"], cfg)
    for mode in ("pcg-standard", "pcg-merged"):
        assert got["n_iterations"][mode] == want["n_iterations"][mode]
    assert all(got["finite"].values()) and got["coherent"]
    np.testing.assert_allclose(got["l2_norm"], want["l2_norm"], rtol=1e-10)


def test_driver_writes_the_pcg_merged_solution_as_pvtr(ranks, pvtr_dir, tmp_path):
    """``run_cycle_distributed(write_solution=...)``: rank 0 writes the
    pcg-merged solution as one .vtr piece a live rank plus the .pvtr master;
    the pieces hold the global solution (its L2 norm the driver's), and the
    files are the JAX writer's for the same blocks."""
    import re
    import struct

    from deal_and_ceed_on_gpu_torch.models import l2_norm_function
    from deal_and_ceed_on_gpu_tpu import BrickMesh as JMesh
    from deal_and_ceed_on_gpu_tpu.parallel import BlockPartition as JPartition
    from deal_and_ceed_on_gpu_tpu.utils.vtk import write_solution_pvtr

    _, shards, _, spec = CASES["driver_2x2"]
    mesh = pt.BrickMesh.bp5_cycle(spec["cycle"])
    part = BlockPartition(mesh, 5, *shards)
    master = pvtr_dir / "bp5.pvtr"
    pieces = re.findall(r'<Piece Extent="([^"]+)" Source="([^"]+)"/>', master.read_text())
    # mz = 1 on pz = 2: the upper blocks hold the top plane alone
    assert [src for _, src in pieces] == [f"bp5_{k}.vtr" for k in range(part.n_shards)]
    g = np.full(part.global_grid_shape, np.nan)
    for ext, src in pieces:
        x0, x1, y0, y1, z0, z1 = (int(v) for v in ext.split())
        body = (pvtr_dir / src).read_bytes().split(b'<AppendedData encoding="raw">\n_', 1)[1]
        (n,) = struct.unpack("<Q", body[:8])
        g[z0:z1 + 1, y0:y1 + 1, x0:x1 + 1] = np.frombuffer(body[8:8 + n]).reshape(z1 - z0 + 1, y1 - y0 + 1, -1)
    assert np.isfinite(g).all()
    got = ranks["driver_2x2"][0] if isinstance(ranks["driver_2x2"], list) else ranks["driver_2x2"]
    space = pt.FESpace.create(mesh, 5, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(float(l2_norm_function(space, torch.as_tensor(g.reshape(-1)))), got["l2_norm"],
                               rtol=1e-14)
    jpart = JPartition(JMesh.bp5_cycle(spec["cycle"]), 5, pz=shards[0], py=shards[1], px=shards[2])
    write_solution_pvtr(str(tmp_path / "bp5.pvtr"), jpart, jpart.to_blocks(g))
    for name in ["bp5.pvtr"] + [src for _, src in pieces]:
        assert (pvtr_dir / name).read_bytes() == (tmp_path / name).read_bytes(), name


def test_dist_banded_bf16_vectors_apply_as_on_one_device(ranks):
    """K2's shard mode with bf16-stored vectors (f32 compute): the gathered
    apply against the single-device plain K2 on the global probe, to a few
    bf16 roundings (each partial and its sum are rounded), shared planes
    bitwise equal."""
    got = ranks["banded_bf16_2x2"]
    _, shards, n_el, spec = CASES["banded_bf16_2x2"]
    assert got["dtype"] == "torch.bfloat16" and got["coherent"]
    mesh = pt.BrickMesh(n_el)
    t = bd.BandedTables.create(mesh, pt.Basis1D.make(P, P + 2, "gauss"), torch.float32, "cpu", spec["kind"])
    u = torch.as_tensor(_probe(t.shape, 1), dtype=torch.float32).to(torch.bfloat16)
    want = bd.banded_apply(u, t).double().numpy()
    y = _assemble(shards, n_el, got["y"])
    np.testing.assert_allclose(y, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_dist_lambda_estimate_equals_single_device(ranks):
    """The driver's power-iteration bound on the distributed stencil (the
    same draws, a rank's block of them, weighted all-reduced norms) equals
    the single-device one."""
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import estimate_lambda_max

    _, _, n_el, _ = CASES["lambda_2x2"]
    space = pt.FESpace.create(pt.BrickMesh(n_el), P, dtype=torch.float64, device="cpu")
    want = estimate_lambda_max(pt.PoissonOperator(space, backend="stencil"), space.n_dofs)
    np.testing.assert_allclose(ranks["lambda_2x2"]["lambda"], want, rtol=1e-12)


def test_nccl_refuses_more_ranks_than_cards():
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import main
    from deal_and_ceed_on_gpu_torch.parallel import spawn

    with pytest.raises(ValueError, match="nccl"):
        spawn(_rank_main, 2, args=({},), backend="nccl", device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        main(["--cycle-min", "3", "--cycle-max", "3", "--shards", "2x1", "--dist-backend", "nccl", "--device", "cpu"])
