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
# with CASES, every degree the kernels take (1..8), on small bricks
EVERY_DEGREE = CASES + [((3, 2, 2), 1), ((2, 3, 2), 4), ((2, 2, 2), 6), ((2, 2, 2), 7)]
# the card's checks: a brick whose grid spans two or three of K1's tiles in x
# and y and several z ranges (nx of 41-43 points, ny of 37-41, nz = 3p+1),
# one element, (4, 3, 6), and a brick three or more tiles wide and high (nx
# of 73-78 points, ny of 67-73), so that a tile has neighbours on both sides.
# K1 balances its tiles (an axis of n points in ceil(n / tile) tiles of n /
# tiles points, rounded down or up), so a thread holds points on both sides
# of a tile's edge where a width is not a multiple of its columns or a height
# not a multiple of its rows (test_ragged_bricks_cross_every_tile_edge)
def _ragged_brick(p):
    return (-(-72 // p), -(-66 // p), 2)


def _tile_edge_bricks(p):
    return [(-(-40 // p), -(-36 // p), 3), (1, 1, 1), (4, 3, 6), _ragged_brick(p)]


# K1's tile per storage label and p (Cfg in csrc/stencil.cu; stencil_tile
# reads it from a built library): (columns a thread, rows a thread, tile
# rows); a tile is 32 columns wide
def _k1_tile(label, p):
    if label == "f64":
        x, r, nw = (2 if p <= 5 else 1), (2 if p == 6 else 1), (6 if p <= 5 else 4)
    else:
        x, r, nw = (2 if p <= 6 else 1), 2, (4 if p <= 6 else 8)
    return x, r, nw * x * r


def _balanced(n, tile):
    """The number of tiles K1 cuts an axis of n points into, and their widths."""
    g = -(-n // tile)
    return g, {(b + 1) * n // g - b * n // g for b in range(g)}


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


@pytest.mark.parametrize("shape,p", EVERY_DEGREE)
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


@pytest.mark.parametrize("shape,p", EVERY_DEGREE)
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


@pytest.mark.parametrize("nc", [1, 3])
def test_cpu_apply_writes_out(nc):
    """``out=``: the twin's result written into the given CPU buffer (every
    entry, from NaN) and returned; no launch counted."""
    _, ts = _spaces((3, 2, 4), 3)
    tables = st.StencilTables.create(ts.mesh, ts.basis, torch.float64, device="cpu")
    shape = ts.grid_shape if nc == 1 else (nc, *ts.grid_shape)
    u = torch.as_tensor(_random(shape, seed=8))
    out = torch.full_like(u, float("nan"))
    before = st.LAUNCHES
    got = st.stencil_apply(u, tables, out=out)
    assert got is out and st.LAUNCHES == before
    assert torch.equal(out, st.stencil_apply_reference(u, tables))


def test_wrapper_rejects_bad_out():
    """``out`` of another shape, dtype or device, strided, or overlapping u
    is refused before anything is written."""
    _, ts = _spaces((2, 3, 4), 2)
    tables = st.StencilTables.create(ts.mesh, ts.basis, torch.float64, device="cpu")
    u = torch.as_tensor(_random(ts.grid_shape))
    bad = [
        torch.empty(ts.grid_shape[::-1], dtype=torch.float64),  # shape
        torch.empty((1, *ts.grid_shape), dtype=torch.float64),  # a component axis u lacks
        torch.empty(ts.grid_shape, dtype=torch.float32),  # dtype
        torch.empty(ts.grid_shape, dtype=torch.float64, device="meta"),  # device
        torch.empty((*ts.grid_shape[:2], 2 * ts.grid_shape[2]), dtype=torch.float64)[..., ::2],  # strided
        u,  # u itself
    ]
    for out in bad:
        with pytest.raises(ValueError, match="out"):
            st.stencil_apply(u, tables, out=out)
    assert torch.equal(u, torch.as_tensor(_random(ts.grid_shape)))


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


def test_library_call_is_the_same_operator():
    """bench_k1_k5's yardstick, torch.matmul(U, A_loc) on the gathered
    element vectors, overlap-added, is the plain K1 on the free rows."""
    from deal_and_ceed_on_gpu_torch.ops.local_global import gather_elements, scatter_elements
    from deal_and_ceed_on_gpu_torch.scripts import bench_k1_k5

    _, ts = _spaces((3, 2, 4), 5)
    library = bench_k1_k5._library(ts.mesh, ts.basis, torch.float64, "cpu")
    tables = st.StencilTables.create(ts.mesh, ts.basis, torch.float64, device="cpu")
    u = torch.as_tensor(_random(tables.shape, seed=5))
    face = st.face_mask(tables.shape, "cpu")
    U = gather_elements(torch.where(face, torch.zeros_like(u), u), ts.mesh.n_elements, 5)
    got = scatter_elements(library(U), ts.mesh.n_elements, 5).reshape(tables.shape)
    want = st.stencil_apply_reference(u, tables)
    assert float((got[~face] - want[~face]).abs().max()) <= 1e-13 * float(want.abs().max())


def test_bench_k1_k5_needs_a_card_and_known_shapes(monkeypatch):
    from deal_and_ceed_on_gpu_torch.scripts import bench_k1_k5

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench_k1_k5.main()
    with pytest.raises(ValueError, match="unknown K1 shape"):
        next(bench_k1_k5.k1_shapes(["bp7"], device="cpu"))
    with pytest.raises(ValueError, match="unknown K5 shape"):
        next(bench_k1_k5.k5_shapes(["bp6"], device="cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("storage,compute,tol", [
    (torch.float64, torch.float64, 1e-13),
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 3e-2),
])
def test_kernel_matches_twin_on_card(cuda_device, p, storage, compute, tol):
    """From a NaN-filled output (every entry written), on bricks whose grids
    are not a multiple of K1's tile in x, y or z and on one element."""
    for n_el in _tile_edge_bricks(p):
        mesh = pt.BrickMesh(n_el, upper=UPPER)
        tables = st.StencilTables.create(mesh, pt.Basis1D.make(p), compute, cuda_device)
        u = torch.as_tensor(_random(tables.shape, seed=p), device=cuda_device).to(storage)
        before = st.LAUNCHES
        got = st.stencil_apply(u, tables, out=torch.full_like(u, float("nan")))
        torch.cuda.synchronize()
        assert st.LAUNCHES == before + 1
        want = st.stencil_apply_reference(u, tables)
        assert bool(torch.isfinite(got).all()), n_el
        err = (got.double() - want.double()).abs().max() / want.double().abs().max()
        assert float(err) <= tol, n_el
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
    for n_el in [(4, 3, 6), _ragged_brick(p)]:
        mesh = pt.BrickMesh(n_el, upper=UPPER)
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
        assert float(err) <= tol, n_el


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
    for n_el in [(4, 3, 6), _ragged_brick(p)]:
        mesh = pt.BrickMesh(n_el, upper=UPPER)
        tables = st.StencilTables.create(mesh, pt.Basis1D.make(p), compute, cuda_device)
        u = torch.as_tensor(_random((3, *tables.shape), seed=p), device=cuda_device).to(storage)
        before = st.NC_LAUNCHES
        got = st.stencil_apply(u, tables)
        torch.cuda.synchronize()
        assert st.NC_LAUNCHES == before + 1
        assert torch.equal(got, torch.stack([st.stencil_apply(u[c], tables) for c in range(3)]))
        want = st.stencil_apply_reference(u, tables)
        err = (got.double() - want.double()).abs().max() / want.double().abs().max()
        assert float(err) <= tol, n_el


@pytest.mark.cuda
@pytest.mark.parametrize("storage,compute", [
    (torch.float64, torch.float64),
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32),
])
def test_kernel_is_bitwise_repeatable_on_card(cuda_device, storage, compute):
    """Two applies of K1 on the same input at the cycle-33 grid (161 x 161 x
    481, p = 5) are bitwise equal: no atomics, each point's sum in a fixed
    order."""
    tables = st.StencilTables.create(pt.BrickMesh.bp5_cycle(33), pt.Basis1D.make(5), compute, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    u = torch.randn(tables.shape, generator=g, device=cuda_device, dtype=compute).to(storage)
    first = st.stencil_apply(u, tables)
    second = st.stencil_apply(u, tables, out=torch.full_like(u, float("nan")))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_ragged_bricks_cross_every_tile_edge():
    """For every storage type and degree, the card's bricks hold a tile with
    neighbours on both sides in x and in y, a tile whose width is not a
    multiple of a thread's columns, and one whose height is not a multiple of
    a thread's rows nor of a warp's (where those are more than one)."""
    for label in ("f64", "f32", "bf16"):
        for p in range(1, 9):
            x, r, th = _k1_tile(label, p)
            tiles = [(_balanced(mx * p + 1, 32), _balanced(my * p + 1, th)) for mx, my, _ in _tile_edge_bricks(p)]
            assert any(gx >= 3 and gy >= 3 for (gx, _), (gy, _) in tiles), (label, p)
            widths = {w for (_, ws), _ in tiles for w in ws}
            heights = {h for _, (_, hs) in tiles for h in hs}
            assert x == 1 or any(w % x for w in widths), (label, p)
            assert r == 1 or any(h % r for h in heights), (label, p)
            assert x * r == 1 or any(h % (x * r) for h in heights), (label, p)


@pytest.mark.cuda
def test_k1_tile_table_matches_the_kernel(cuda_device):
    """_k1_tile, which the check of the bricks reads, is the tile K1 is
    built with (its library's stencil_tile)."""
    from deal_and_ceed_on_gpu_torch.scripts import k1_sass
    from deal_and_ceed_on_gpu_torch.utils.cuda_build import build_library

    library = build_library(st.SOURCE)
    for label, code in (("f64", 0), ("f32", 1), ("bf16", 2)):
        for p in range(1, 9):
            t = k1_sass.tile(library, code, p)
            assert (t["x"], t["r"], t["th"], t["tw"]) == (*_k1_tile(label, p), 32), (label, p)


def test_k1_sass_counts_the_plane_loop():
    """scripts/k1_sass on a made-up listing: the loop that holds the barrier,
    its instructions by kind and the bytes its LDS read."""
    from deal_and_ceed_on_gpu_torch.scripts import k1_sass

    listing = """
        Function : _ZN12_GLOBAL__N_114stencil_kernelIffLi5ELb0ELb0ELb0EEEvNS_6ParamsIT_T0_EE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDS.64 R4, [R2+0x10] ;
        /*0030*/                   LDS R5, [R2] ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/                   FFMA R6, R4, R5, R6 ;
        /*0060*/                   IMAD.MOV.U32 R7, RZ, RZ, R6 ;
        /*0070*/                   STS [R3], R6 ;
        /*0080*/                   LDS.128 R8, [R3+0x20] ;
        /*0090*/               @P0 BRA 0x20 ;
        /*00a0*/                   STG.E [R10.64], R6 ;
        /*00b0*/                   EXIT ;
        Function : _Z5otherv
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
"""
    fns = k1_sass.sass_functions(listing)
    name = next(n for n in fns if "stencil" in n)
    assert k1_sass.kernel_key(name) == ("f32", "f", 5, False, False, False)
    assert k1_sass.kernel_key("_Z5otherv") is None
    loop = k1_sass.plane_loop(fns[name])
    assert loop[0].startswith("LDS.64") and loop[-1] == "@P0 BRA 0x20"
    kinds = k1_sass.classify(loop)
    assert (kinds["LDS"], kinds["STS"], kinds["BAR"], kinds["FMA"], kinds["MOV"], kinds["total"]) == (3, 1, 1, 1, 1, 8)
    assert k1_sass.shared_bytes(loop) == 8 + 4 + 16
    with pytest.raises(ValueError, match="no loop"):
        k1_sass.plane_loop(fns["_Z5otherv"])
