"""K1 (ops/stencil.py): host tables, the plain twin against the JAX Pallas
stencil kernel in interpret mode (with and without the Helmholtz value
term), fold_scale, the wrapper's checks, and the CUDA kernel against its
twin on a card (skipped without one)."""

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.ops import stencil as st
from deal_and_ceed_on_gpu_torch.utils.convert import stencil_tables_from_jax, stencil_value_from_jax

try:
    import jax.numpy as jnp

    from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace
    from deal_and_ceed_on_gpu_tpu.models import HelmholtzOperator, PoissonOperator
    from deal_and_ceed_on_gpu_tpu.ops.pallas_stencil import StencilLayout
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    jnp = None

UPPER = (1.0, 0.8, 1.3)
CASES = [((2, 3, 4), 2), ((2, 2, 2), 5), ((8, 4, 10), 3), ((2, 2, 2), 8)]


def _spaces(shape, p, jdtype=None, tdtype=torch.float64):
    jdtype = jnp.float64 if jdtype is None else jdtype
    js = FESpace.create(BrickMesh(shape, upper=UPPER), p, rule="gauss_lobatto", dtype=jdtype)
    ts = pt.FESpace.create(pt.BrickMesh(shape, upper=UPPER), p, rule="gauss_lobatto", dtype=tdtype, device="cpu")
    return js, ts


def _jax_stencil_op(space, **opts):
    op = PoissonOperator(space, backend="pallas", pallas_opts=opts or None)
    op._stencil.interpret = True
    return op


def _random(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("shape,p", CASES + [((3, 2, 5), 1), ((4, 3, 2), 4)])
def test_tables_equal_converted_jax_layout(shape, p):
    js, ts = _spaces(shape, p)
    L = StencilLayout(js.mesh, js.basis, jnp.float64)
    want = stencil_tables_from_jax(
        L.sz_np, L.sy_np, L.sx_np, L.bz_np, L.by_np, L.bx_np, p, L.real_shape
    )
    got = st.stencil_tables_np(ts.mesh, ts.basis)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tables = st.StencilTables.create(ts.mesh, ts.basis, torch.float64, device="cpu")
    assert tables.shape == ts.grid_shape == L.real_shape
    # the converted JAX state drives the port's apply unchanged
    converted = st.StencilTables.from_numpy(want, p, torch.float64, device="cpu")
    u = torch.as_tensor(_random(ts.n_dofs, seed=5)).reshape(ts.grid_shape)
    np.testing.assert_array_equal(
        st.stencil_apply(u, converted).numpy(), st.stencil_apply(u, tables).numpy()
    )


@pytest.mark.parametrize("shape,p", CASES)
def test_vector_order_matches_jax_layout(shape, p):
    """Both packages order the real DoFs z slowest over [nz, ny, nx]: the
    real block of the JAX padded layout is the port's grid."""
    js, ts = _spaces(shape, p)
    L = StencilLayout(js.mesh, js.basis, jnp.float64)
    u = _random(js.n_dofs, seed=3)
    up = np.asarray(L.pad_flat(jnp.asarray(u))).reshape(L.padded_shape)
    nz, ny, nx = ts.grid_shape
    np.testing.assert_array_equal(up[p : p + nz, 8 : 8 + ny, :nx], u.reshape(ts.grid_shape))


@pytest.mark.parametrize("shape,p", CASES)
def test_twin_matches_jax_pallas_interpret(shape, p):
    js, ts = _spaces(shape, p)
    u = _random(js.n_dofs)
    want = np.asarray(_jax_stencil_op(js).vmult(jnp.asarray(u)))
    tables = st.StencilTables.create(ts.mesh, ts.basis, torch.float64, device="cpu")
    got = st.stencil_apply_reference(torch.as_tensor(u).reshape(ts.grid_shape), tables)
    np.testing.assert_allclose(got.reshape(-1).numpy(), want, rtol=1e-13, atol=1e-13)
    # the port's stencil backend (twin on CPU) is the same apply
    op = pt.PoissonOperator(ts, backend="stencil")
    np.testing.assert_allclose(op.vmult(torch.as_tensor(u)).numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("shape,p", CASES)
def test_value_twin_matches_jax_pallas_interpret(shape, p):
    """K1's value term: the twin on the JAX Helmholtz kernel's tables (value
    table carried across) against the JAX pallas backend in interpret mode,
    and the port's own value table equal to the converted one."""
    js, ts = _spaces(shape, p)
    jop = HelmholtzOperator(js, backend="pallas", pallas_opts=dict(interpret=True))
    u = _random(js.n_dofs, seed=6)
    want = np.asarray(jop.vmult(jnp.asarray(u)))
    L = jop.layout
    tabs = stencil_tables_from_jax(L.sz_np, L.sy_np, L.sx_np, L.bz_np, L.by_np, L.bx_np, p, L.real_shape)
    tabs["a"] = stencil_value_from_jax(jop._stencil._a, L.real_shape)
    tables = st.StencilTables.from_numpy(tabs, p, torch.float64, device="cpu")
    got = st.stencil_apply_reference(torch.as_tensor(u).reshape(ts.grid_shape), tables)
    np.testing.assert_allclose(got.reshape(-1).numpy(), want, rtol=1e-13, atol=1e-13)
    own = pt.HelmholtzOperator(ts, backend="stencil")._stencil.a
    np.testing.assert_array_equal(own.numpy(), tabs["a"])


@pytest.mark.parametrize("shape,p", CASES)
def test_stencil_backend_matches_separable(shape, p):
    _, ts = _spaces(shape, p)
    u = torch.as_tensor(_random(ts.n_dofs, seed=1))
    a = pt.PoissonOperator(ts, backend="stencil").vmult(u)
    b = pt.PoissonOperator(ts, backend="separable").vmult(u)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("shape,p", [((2, 3, 4), 2), ((8, 4, 10), 3)])
def test_bf16_stream_matches_jax_f32(shape, p):
    """bf16 storage, f32 accumulation: the result matches JAX's f32 operator
    to bf16 rounding (input and output rounded once each)."""
    js, ts = _spaces(shape, p, jnp.float32, torch.float32)
    u = _random(js.n_dofs, seed=2).astype(np.float32)
    want = np.asarray(_jax_stencil_op(js).vmult(jnp.asarray(u)), dtype=np.float64)
    op = pt.PoissonOperator(ts, backend="stencil", stream_dtype=torch.bfloat16)
    got = op.vmult(torch.as_tensor(u).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    assert err < 3e-2


def test_fold_scale_scales_the_kernel_tables():
    _, ts = _spaces((3, 2, 2), 3)
    op = pt.PoissonOperator(ts, backend="stencil")
    u = torch.as_tensor(_random(ts.n_dofs, seed=4))
    before = op.vmult(u)
    bz = op._stencil.bz
    op.fold_scale(0.25)
    assert op._stencil.bz is bz  # scaled in place: the tensor the kernel reads
    after = op.vmult(u)
    mask = ts.dirichlet_mask
    np.testing.assert_array_equal(after[mask].numpy(), u[mask].numpy())
    np.testing.assert_allclose(after[~mask].numpy(), 0.25 * before[~mask].numpy(), rtol=1e-14, atol=1e-14)


def test_fold_scale_scales_the_value_table():
    _, ts = _spaces((3, 2, 2), 3)
    op = pt.HelmholtzOperator(ts, backend="stencil")
    a = op._stencil.a.clone()
    op.fold_scale(0.5)
    np.testing.assert_array_equal(op._stencil.a.numpy(), 0.5 * a.numpy())
    with pytest.raises(ValueError, match="value table"):
        tabs = st.stencil_tables_np(ts.mesh, ts.basis)
        tabs["a"] = np.ones((2, 2, 2))
        st.stencil_apply(torch.zeros(ts.grid_shape, dtype=torch.float64),
                         st.StencilTables.from_numpy(tabs, 3, torch.float64, device="cpu"))


def test_cpu_apply_uses_the_twin_and_counts_no_launch():
    _, ts = _spaces((2, 2, 2), 2)
    tables = st.StencilTables.create(ts.mesh, ts.basis, torch.float64, device="cpu")
    u = torch.as_tensor(_random(ts.n_dofs)).reshape(ts.grid_shape)
    before = st.LAUNCHES
    np.testing.assert_array_equal(st.stencil_apply(u, tables).numpy(), st.stencil_apply_reference(u, tables).numpy())
    assert st.LAUNCHES == before


def test_wrapper_rejects_bad_inputs():
    _, ts = _spaces((2, 2, 2), 2)
    t64 = st.StencilTables.create(ts.mesh, ts.basis, torch.float64, device="cpu")
    t32 = st.StencilTables.create(ts.mesh, ts.basis, torch.float32, device="cpu")
    u = torch.zeros(ts.grid_shape, dtype=torch.float64)
    with pytest.raises(TypeError):
        st.stencil_apply(u.float(), t64)  # f32 storage with f64 tables
    with pytest.raises(TypeError):
        st.stencil_apply(u.to(torch.bfloat16), t64)
    with pytest.raises(ValueError):
        st.stencil_apply(u.reshape(-1), t64)  # flat
    with pytest.raises(ValueError):
        st.stencil_apply(u.transpose(0, 2), t64)  # wrong shape
    with pytest.raises(ValueError):
        st.stencil_apply(torch.zeros((5, 5, 10), dtype=torch.float32)[:, :, ::2], t32)  # strided
    assert st.stencil_apply(u.to(torch.bfloat16), t32).dtype == torch.bfloat16


def test_tables_reject_unsupported_configurations():
    with pytest.raises(ValueError):
        st.stencil_tables_np(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(3, rule="gauss"))
    with pytest.raises(ValueError):
        st.stencil_tables_np(pt.BrickMesh.graded([0, 0.3, 1], [0, 1], [0, 1]), pt.Basis1D.make(3))
    with pytest.raises(ValueError):
        st.stencil_tables_np(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(9))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 5, 8])
@pytest.mark.parametrize("storage,compute,tol", [
    (torch.float64, torch.float64, 1e-13),
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 3e-2),
])
def test_kernel_matches_twin_on_card(cuda_device, p, storage, compute, tol):
    mesh = pt.BrickMesh((4, 3, 6), upper=UPPER)
    tables = st.StencilTables.create(mesh, pt.Basis1D.make(p), compute, cuda_device)
    u = torch.as_tensor(_random(tables.shape, seed=p), device=cuda_device).to(storage)
    before = st.LAUNCHES
    got = st.stencil_apply(u, tables)
    torch.cuda.synchronize()
    assert st.LAUNCHES == before + 1
    want = st.stencil_apply_reference(u, tables)
    err = (got.double() - want.double()).abs().max() / want.double().abs().max()
    assert float(err) <= tol
    nz, ny, nx = tables.shape
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert torch.equal(got[sl], u[sl])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 5, 8])
@pytest.mark.parametrize("storage,compute,tol", [
    (torch.float64, torch.float64, 1e-13),
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 3e-2),
])
def test_kernel_with_value_matches_twin_on_card(cuda_device, p, storage, compute, tol):
    mesh = pt.BrickMesh((4, 3, 6), upper=UPPER)
    grid = tuple(m * p + 1 for m in reversed(mesh.n_elements))
    value = 0.5 + np.random.default_rng(p).random(grid)
    tables = st.StencilTables.create(mesh, pt.Basis1D.make(p), compute, cuda_device, value=value)
    u = torch.as_tensor(_random(tables.shape, seed=p), device=cuda_device).to(storage)
    before = st.VALUE_LAUNCHES
    got = st.stencil_apply(u, tables)
    torch.cuda.synchronize()
    assert st.VALUE_LAUNCHES == before + 1
    want = st.stencil_apply_reference(u, tables)
    err = (got.double() - want.double()).abs().max() / want.double().abs().max()
    assert float(err) <= tol


@pytest.mark.parametrize("value", [False, True])
def test_components_match_single_calls(value):
    """K1 on [3, nz, ny, nx]: the shared tables (and value table) applied
    per component in one call, equal to three single calls; identity faces
    per component."""
    _, ts = _spaces((4, 3, 2), 3)
    a = 0.5 + np.random.default_rng(1).random(ts.grid_shape) if value else None
    tables = st.StencilTables.create(ts.mesh, ts.basis, torch.float64, device="cpu", value=a)
    u = torch.as_tensor(_random((3, *ts.grid_shape), seed=7))
    got = st.stencil_apply(u, tables)
    for c in range(3):
        assert torch.equal(got[c], st.stencil_apply(u[c].contiguous(), tables))
    face = st.face_mask(ts.grid_shape, "cpu").expand(u.shape)
    assert torch.equal(got[face], u[face])
    with pytest.raises(ValueError):
        st.stencil_apply(u[None], tables)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 5, 8])
@pytest.mark.parametrize("storage,compute,tol", [
    (torch.float64, torch.float64, 1e-13),
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 3e-2),
])
def test_kernel_with_components_on_card(cuda_device, p, storage, compute, tol):
    """nc = 3 in one launch: equal to three 1-component launches, and to the
    twin within the kernel's tolerance."""
    mesh = pt.BrickMesh((4, 3, 6), upper=UPPER)
    tables = st.StencilTables.create(mesh, pt.Basis1D.make(p), compute, cuda_device)
    u = torch.as_tensor(_random((3, *tables.shape), seed=p), device=cuda_device).to(storage)
    before = st.NC_LAUNCHES
    got = st.stencil_apply(u, tables)
    torch.cuda.synchronize()
    assert st.NC_LAUNCHES == before + 1
    assert torch.equal(got, torch.stack([st.stencil_apply(u[c], tables) for c in range(3)]))
    want = st.stencil_apply_reference(u, tables)
    err = (got.double() - want.double()).abs().max() / want.double().abs().max()
    assert float(err) <= tol
