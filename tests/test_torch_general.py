"""K4 (ops/general.py): the plain version against the JAX Pallas general
kernel in interpret mode across every grad x val mode (Gauss q = p+1, p+2
and GLL, p = 1..4, an element tail), tables carried across with
general_tables_from_jax, fold_scale, the element-major gather and scatter,
the wrapper's checks, step-64 on the ``general`` backend, and the CUDA
kernel against its plain version on a card (skipped without one)."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import HelmholtzOperator, MassOperator, PoissonOperator
from deal_and_ceed_on_gpu_torch.ops import general as gk
from deal_and_ceed_on_gpu_torch.ops import local_global as lg
from deal_and_ceed_on_gpu_torch.utils.convert import general_tables_from_jax

try:
    import jax.numpy as jnp

    from deal_and_ceed_on_gpu_tpu.basis import Basis1D as BasisJ
    from deal_and_ceed_on_gpu_tpu.ops.pallas_general import GeneralCellKernel as KernelJ
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    jnp = None

TOL = {torch.float64: 1e-13, torch.float32: 1e-5}  # of max|want|
MODES = [(g, v) for g in (None, "const", "diag3", "full6") for v in (None, "const", "table") if g or v]
N_CELLS = 37  # JAX pads to one block of 40 cells (block_e = 64): a tail of 3
RULES = {"gauss_p1": ("gauss", 1), "gauss_p2": ("gauss", 2), "gll": ("gauss_lobatto", 1)}


def _specs(E, Q, grad, val, seed):
    """Term specs with random positive tables (full6 diagonally dominant)."""
    rng = np.random.default_rng(seed)
    gspec = vspec = None
    if grad == "const":
        gspec = ("const", (1.3, 0.7, 1.1))
    elif grad == "diag3":
        gspec = ("diag3", 0.5 + rng.random((E, Q, 3)))
    elif grad == "full6":
        c = 0.2 * rng.random((E, Q, 6))
        c[..., (0, 3, 5)] += 1.0
        gspec = ("full6", c)
    if val == "const":
        vspec = ("const", 2.5)
    elif val == "table":
        vspec = ("table", 0.5 + rng.random((E, Q)))
    return gspec, vspec


def _check_modes(p, rule, dtype):
    name, qoff = RULES[rule]
    q = p + qoff
    basis = pt.Basis1D.make(p, q, name)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    for i, (grad, val) in enumerate(MODES):
        gspec, vspec = _specs(N_CELLS, q**3, grad, val, seed=10 * p + i)
        kj = KernelJ(BasisJ.make(p, q, name), N_CELLS, npdt, grad=gspec, val=vspec, block_e=64, interpret=True)
        u = np.random.default_rng(i).standard_normal((N_CELLS, (p + 1) ** 3)).astype(npdt)
        want = np.asarray(kj.apply_local(jnp.asarray(u)))
        k = gk.GeneralCellKernel(basis, N_CELLS, dtype, grad=gspec, val=vspec, device="cpu")
        got = gk.general_apply_reference(torch.as_tensor(u), k).numpy()
        tol = TOL[dtype] * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{grad} {val}")
        # the tables carried across from the JAX kernel give the same apply
        kc = gk.GeneralCellKernel.from_numpy(general_tables_from_jax(kj, basis), dtype, "cpu")
        np.testing.assert_allclose(gk.general_apply(torch.as_tensor(u), kc).numpy(), want, rtol=0, atol=tol)


@pytest.mark.skipif(jnp is None, reason="needs the JAX package")
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_reference_matches_jax_interpret_f64(p, rule):
    _check_modes(p, rule, torch.float64)


@pytest.mark.skipif(jnp is None, reason="needs the JAX package")
@pytest.mark.parametrize("p", [2, 4])
def test_reference_matches_jax_interpret_f32(p):
    _check_modes(p, "gauss_p2", torch.float32)


@pytest.mark.skipif(jnp is None, reason="needs the JAX package")
def test_converted_tables_equal_the_ports_own():
    """general_tables_from_jax cuts the padded streams to E cells; the port
    builds the same tables itself, and a basis mismatch raises."""
    p, q = 3, 5
    gspec, vspec = _specs(N_CELLS, q**3, "full6", "table", seed=3)
    kj = KernelJ(BasisJ.make(p, q, "gauss"), N_CELLS, np.float64, grad=gspec, val=vspec, block_e=64, interpret=True)
    basis = pt.Basis1D.make(p, q, "gauss")
    got = general_tables_from_jax(kj, basis)
    want = gk.general_tables_np(basis, N_CELLS, gspec, vspec)
    assert set(got) == set(want)
    for key, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[key], v, err_msg=key)
        else:
            assert got[key] == v, key
    assert got["C"].shape == (6, N_CELLS, q**3) and got["av"].shape == (N_CELLS, q**3)
    with pytest.raises(ValueError, match="basis"):
        general_tables_from_jax(kj, pt.Basis1D.make(p, q, "gauss_lobatto"))


def test_const_mode_is_one_element_matrix():
    """grad const and val const: K4 computes ``U @ A_loc`` with
    ``A_loc = sum_d G_d diag(cw_d) G_d^T + V diag(vw) V^T``."""
    basis = pt.Basis1D.make(3, 5, "gauss")
    k = gk.GeneralCellKernel(basis, 11, torch.float64, grad=("const", (1.0, 2.0, 0.5)), val=("const", 3.0),
                             device="cpu")
    V, G = k.dense_tables
    a_loc = sum((G[d] * k.cw[d]) @ G[d].T for d in range(3)) + (V * k.vw) @ V.T
    u = torch.as_tensor(np.random.default_rng(0).standard_normal((11, 64)))
    np.testing.assert_allclose(k.apply_local(u).numpy(), (u @ a_loc).numpy(), rtol=0, atol=1e-13 * 50)
    np.testing.assert_allclose(a_loc.numpy(), a_loc.numpy().T, rtol=0, atol=1e-14 * float(a_loc.abs().max()))


def test_fold_scale_scales_the_tables_in_place():
    basis = pt.Basis1D.make(2, 4, "gauss")
    gspec, vspec = _specs(5, 64, "full6", "table", seed=1)
    k = gk.GeneralCellKernel(basis, 5, torch.float64, grad=gspec, val=vspec, device="cpu")
    u = torch.as_tensor(np.random.default_rng(2).standard_normal((5, 27)))
    before = k.apply_local(u)
    C, av = k.C, k.av
    k.fold_scale(0.25)
    assert k.C is C and k.av is av  # the tensors the kernel reads
    np.testing.assert_allclose(k.apply_local(u).numpy(), 0.25 * before.numpy(), rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("cls", [PoissonOperator, HelmholtzOperator, MassOperator])
def test_operator_fold_scale_on_general(cls):
    mesh = pt.BrickMesh((2, 3, 2)).deform(*pt.sine_map(0.05))
    space = pt.FESpace.create(mesh, 2, n_q=4, rule="gauss", dtype=torch.float64, device="cpu")
    op = cls(space, backend="general")
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(space.n_dofs))
    before = op.vmult(u)
    d0 = op.compute_diagonal()
    op.fold_scale(0.5)
    after = op.vmult(u)
    mask = space.dirichlet_mask
    assert torch.equal(after[mask], u[mask])
    np.testing.assert_allclose(after[~mask].numpy(), 0.5 * before[~mask].numpy(), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(op.compute_diagonal()[~mask].numpy(), 0.5 * d0[~mask].numpy(), rtol=1e-14)


@pytest.mark.parametrize("shape,p", [((3, 2, 4), 2), ((2, 2, 1), 3)])
def test_element_major_gather_and_scatter(shape, p):
    """gather_elements = the structured gather transposed to [E, N];
    scatter_elements = its overlap-add; the two are adjoint."""
    mx, my, mz = shape
    grid = (mz * p + 1, my * p + 1, mx * p + 1)
    rng = np.random.default_rng(p)
    u = torch.as_tensor(rng.standard_normal(grid))
    ul = lg.gather_elements(u, shape, p)
    want = lg.gather_structured(u, shape, p).permute(0, 2, 4, 1, 3, 5).reshape(mx * my * mz, -1)
    assert torch.equal(ul, want)
    w = torch.as_tensor(rng.standard_normal(ul.shape))
    v = lg.scatter_elements(w, shape, p)
    assert torch.equal(v, lg.scatter_structured(w.reshape(mz, my, mx, p + 1, p + 1, p + 1)
                                                 .permute(0, 3, 1, 4, 2, 5), p))
    np.testing.assert_allclose(float((ul * w).sum()), float((u * v).sum()), rtol=1e-13)


def test_cpu_apply_counts_no_launch():
    k = gk.GeneralCellKernel(pt.Basis1D.make(2, 3, "gauss"), 4, torch.float64, val=("const", 1.0), device="cpu")
    before = gk.LAUNCHES
    k.apply_local(torch.zeros(4, 27, dtype=torch.float64))
    assert gk.LAUNCHES == before


def test_wrapper_rejects_bad_inputs():
    k = gk.GeneralCellKernel(pt.Basis1D.make(2, 4, "gauss"), 4, torch.float64, grad=("const", (1.0, 1.0, 1.0)),
                             device="cpu")
    u = torch.zeros(4, 27, dtype=torch.float64)
    with pytest.raises(TypeError):
        gk.general_apply(u.float(), k)
    with pytest.raises(ValueError):
        gk.general_apply(u[:3], k)
    with pytest.raises(ValueError):
        gk.general_apply(torch.zeros(27, 4, dtype=torch.float64).T, k)
    with pytest.raises(ValueError):
        gk.general_apply(u, k, out=torch.zeros(4, 26, dtype=torch.float64))
    out = torch.full_like(u, float("nan"))
    assert gk.general_apply(u + 1.0, k, out=out) is out and bool(torch.isfinite(out).all())
    k.cw = k.cw[:2]
    with pytest.raises(ValueError):
        gk.general_apply(u, k)


def test_tables_reject_unsupported_configurations():
    basis = pt.Basis1D.make(3, 4, "gauss")
    with pytest.raises(ValueError):
        gk.general_tables_np(basis, 4)  # neither term
    with pytest.raises(ValueError):
        gk.general_tables_np(basis, 4, grad=("full9", None))
    with pytest.raises(ValueError):
        gk.general_tables_np(basis, 4, grad=("full6", np.zeros((4, 64, 3))))
    with pytest.raises(ValueError):
        gk.general_tables_np(pt.Basis1D.make(3, 8, "gauss"), 4, val=("const", 1.0))  # q = p + 5
    with pytest.raises(ValueError):
        gk.general_tables_np(pt.Basis1D.make(9, 10, "gauss"), 4, val=("const", 1.0))  # p > 8


def test_step64_refine2_on_general():
    """The step-64 golden fingerprint on K4's plain version: grad const and
    the a(x) JxW value table, plain and merged CG."""
    from deal_and_ceed_on_gpu_torch.drivers import step64

    for merged in (False, True):
        r = step64.run(2, backend="general", use_merged=merged, device="cpu")
        assert r["n_iterations"] == 60
        assert abs(r["l2_norm"] - 0.020526851356887806) <= 1e-10 * 0.020526851356887806


def test_step64_cli_takes_general(capsys):
    from deal_and_ceed_on_gpu_torch.drivers import step64

    step64.main(["--refine", "1", "--backend", "general", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("Solved in") == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p,rule", [(1, "gauss_p2"), (3, "gll"), (5, "gauss_p2"), (8, "gauss_p1")])
@pytest.mark.parametrize("grad,val", [("const", "table"), ("full6", None), ("diag3", "const"), (None, "table")])
def test_kernel_matches_reference_on_card(cuda_device, p, rule, grad, val, dtype):
    name, qoff = RULES[rule]
    q = p + qoff
    gspec, vspec = _specs(N_CELLS, q**3, grad, val, seed=p)
    k = gk.GeneralCellKernel(pt.Basis1D.make(p, q, name), N_CELLS, dtype, grad=gspec, val=vspec, device=cuda_device)
    u = torch.as_tensor(np.random.default_rng(p).standard_normal((N_CELLS, (p + 1) ** 3)), dtype=dtype,
                        device=cuda_device)
    before = gk.LAUNCHES
    got = gk.general_apply(u, k, out=torch.full_like(u, float("nan")))
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before + 1
    want = gk.general_apply_reference(u, k)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) <= {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]


@pytest.mark.cuda
def test_mapped_poisson_general_matches_structured_on_card(cuda_device):
    mesh = pt.BrickMesh((5, 4, 3)).deform(*pt.sine_map(0.05))
    space = pt.FESpace.create(mesh, 3, n_q=4, rule="gauss", dtype=torch.float64, device=cuda_device)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(space.n_dofs), device=cuda_device)
    before = gk.LAUNCHES
    a = PoissonOperator(space, backend="general").vmult(u)
    assert gk.LAUNCHES == before + 1
    b = PoissonOperator(space, backend="structured").vmult(u)
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-12


def _card_case(p, rule, E, grad, val, dtype, device, seed):
    name, qoff = RULES[rule]
    q = p + qoff
    gspec, vspec = _specs(E, q**3, grad, val, seed=seed)
    k = gk.GeneralCellKernel(pt.Basis1D.make(p, q, name), E, dtype, grad=gspec, val=vspec, device=device)
    u = torch.as_tensor(np.random.default_rng(seed).standard_normal((E, (p + 1) ** 3)), dtype=dtype, device=device)
    return k, u


def _assert_agrees(k, u, got):
    want = gk.general_apply_reference(u, k)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) <= {torch.float64: 1e-12, torch.float32: 1e-5}[u.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [2, 5, 8])
def test_two_rules_of_one_degree_alternate_on_card(cuda_device, p, dtype):
    """Gauss and GLL tables at q = p+1 share K4's instantiation: launched
    alternately with no sync between, on one stream and on two, each
    agrees with its own plain version."""
    cases = [_card_case(p, rule, N_CELLS, "full6", "table", dtype, cuda_device, seed=p + i)
             for i, rule in enumerate(("gauss_p1", "gll"))]
    outs = [torch.full_like(u, float("nan")) for _, u in cases]
    for _ in range(3):
        for (k, u), o in zip(cases, outs):
            gk.general_apply(u, k, out=o)
    torch.cuda.synchronize()
    for (k, u), o in zip(cases, outs):
        _assert_agrees(k, u, o)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [torch.full_like(u, float("nan")) for _, u in cases]
    torch.cuda.synchronize()
    for (k, u), o, s in zip(cases, outs, streams):
        with torch.cuda.stream(s):
            gk.general_apply(u, k, out=o)
    torch.cuda.synchronize()
    for (k, u), o in zip(cases, outs):
        _assert_agrees(k, u, o)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p,rule", [(1, "gauss_p1"), (3, "gauss_p1"), (5, "gauss_p2"), (8, "gauss_p2")])
def test_element_group_edges_on_card(cuda_device, p, rule, dtype):
    """E = 1, and element counts on and just past a block's element group
    (about 128 or 256 threads of q^2: both sizes are covered), from a
    NaN-filled output."""
    q = p + RULES[rule][1]
    groups = {max(1, threads // q**2) for threads in (128, 256)}
    for E in sorted({1} | {eb + d for eb in groups for d in (0, 1)} | {2 * eb + 1 for eb in groups}):
        k, u = _card_case(p, rule, E, "diag3", "const", dtype, cuda_device, seed=E)
        _assert_agrees(k, u, gk.general_apply(u, k, out=torch.full_like(u, float("nan"))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("grad,val", [("full6", "table"), ("const", None)])
def test_many_element_groups_on_card(cuda_device, grad, val, dtype):
    """Many more element groups than the card holds blocks at once (p = 3,
    q = 4: 8 elements a group, 5,001 groups), with a ragged last group."""
    k, u = _card_case(3, "gauss_p1", 40_003, grad, val, dtype, cuda_device, seed=11)
    _assert_agrees(k, u, gk.general_apply(u, k, out=torch.full_like(u, float("nan"))))


@pytest.mark.parametrize("p", range(1, 9))
def test_every_rule_the_kernel_is_built_for_is_symmetric(p):
    """The CUDA kernel's even-odd sweeps need S[q-1-a, p-i] = S[a, i] and
    D[q-1-a, p-i] = -D[a, i]: every Gauss and GLL rule it is built for."""
    for name, q in (("gauss", p + 1), ("gauss", p + 2), ("gauss", p + 3), ("gauss_lobatto", p + 1)):
        k = gk.GeneralCellKernel(pt.Basis1D.make(p, q, name), 2, torch.float64, val=("const", 1.0), device="cpu")
        assert k.symmetric, (name, q)


def test_asymmetric_tables_are_flagged_and_run_plain_on_cpu():
    basis = pt.Basis1D.make(3, 5, "gauss")
    tabs = gk.general_tables_np(basis, 4, grad=("const", (1.0, 2.0, 3.0)))
    tabs["S"] = tabs["S"].copy()
    tabs["S"][0, 0] += 1e-3
    k = gk.GeneralCellKernel.from_numpy(tabs, torch.float64, "cpu")
    assert not k.symmetric
    u = torch.as_tensor(np.random.default_rng(0).standard_normal((4, 64)))
    assert torch.equal(gk.general_apply(u, k), gk.general_apply_reference(u, k))


@pytest.mark.cuda
def test_kernel_refuses_asymmetric_tables_on_card(cuda_device):
    tabs = gk.general_tables_np(pt.Basis1D.make(3, 5, "gauss"), 4, grad=("const", (1.0, 2.0, 3.0)))
    tabs["D"] = tabs["D"].copy()
    tabs["D"][1, 2] += 1e-3
    k = gk.GeneralCellKernel.from_numpy(tabs, torch.float64, cuda_device)
    with pytest.raises(ValueError, match="symmetric"):
        gk.general_apply(torch.zeros(4, 64, dtype=torch.float64, device=cuda_device), k)


def test_bench_k4_needs_a_card_and_known_shapes(monkeypatch):
    from deal_and_ceed_on_gpu_torch.scripts import bench_k4

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench_k4.main()
    with pytest.raises(ValueError, match="unknown shape"):
        next(bench_k4.k4_shapes(["bp7"], device="cpu"))


def test_bench_k4_step64_tables_are_helmholtz_general():
    from deal_and_ceed_on_gpu_torch.scripts import bench_k4

    k = bench_k4.step64_kernel(1, device="cpu")
    space = pt.FESpace.create(pt.BrickMesh.hyper_cube().refine_global(1), 3, rule="gauss", dtype=torch.float64,
                              device="cpu")
    want = HelmholtzOperator(space, backend="general")._general
    assert (k.grad_kind, k.val_kind, k.n_cells) == (want.grad_kind, want.val_kind, want.n_cells)
    for name in ("cw", "C", "vw", "av"):
        a, b = getattr(k, name), getattr(want, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    u = torch.as_tensor(np.random.default_rng(3).standard_normal((k.n_cells, k.n_local)))
    assert torch.equal(gk.general_apply(u, k), want.apply_local(u))
