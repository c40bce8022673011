"""The shard-local pieces of the distributed port, in one process: K1's and
K2's shard tables against the JAX ``StencilLayout(phys_elems, faces)`` and
``BandedLayout(phys_elems, faces)``, the plain shard-mode K1 and K2 (and the
distributed operators' applies without exchange) whose per-rank partial sums
added on the host equal the global apply, ``apply_separable_plane`` and
K1's plane partial against the JAX functions."""

import itertools

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.ops import banded as bd
from deal_and_ceed_on_gpu_torch.ops import stencil as st
from deal_and_ceed_on_gpu_torch.ops.separable import apply_separable, apply_separable_plane, poisson_terms
from deal_and_ceed_on_gpu_torch.parallel import BlockPartition, DistBandedOperator, DistOperator, DistStencilOperator
from deal_and_ceed_on_gpu_torch.utils.convert import JAX_STENCIL_YOFF, banded_tables_from_jax, stencil_tables_from_jax

try:
    import jax.numpy as jnp

    from deal_and_ceed_on_gpu_tpu import BrickMesh as JMesh
    from deal_and_ceed_on_gpu_tpu.basis import Basis1D as JBasis
    from deal_and_ceed_on_gpu_tpu.ops import separable as jsep
    from deal_and_ceed_on_gpu_tpu.ops.pallas_banded import BandedLayout
    from deal_and_ceed_on_gpu_tpu.ops.pallas_stencil import StencilLayout, stencil_plane_padded
except ImportError:  # the card's machine has no jax
    jnp = None

needs_jax = pytest.mark.skipif(jnp is None, reason="needs the JAX package")
UPPER = (1.0, 0.8, 1.3)


def _shard_cases():
    """(local elements, p, phys_elems, faces): every wall combination at p =
    2, dead layers behind an upper wall, and other degrees."""
    out = []
    for faces in itertools.product((False, True), repeat=4):
        out.append(((2, 3, 4), 2, (2, 3, 4), faces))
    out += [((2, 3, 4), 2, (2, 2, 3), (False, True, True, True)), ((3, 3, 3), 3, (3, 1, 3), (True, False, False, True)),
            ((2, 2, 3), 5, (2, 2, 1), (False, True, False, False)), ((3, 4, 2), 1, (3, 3, 0), (False, True, True, True)),
            ((2, 2, 2), 8, (2, 2, 2), (False, False, True, False))]
    return out


@needs_jax
@pytest.mark.parametrize("n_el,p,phys,faces", _shard_cases())
def test_stencil_shard_tables_equal_jax_layout(n_el, p, phys, faces):
    L = StencilLayout(JMesh(n_el, upper=UPPER), JBasis.make(p), jnp.float64, phys_elems=phys, faces=faces)
    want = stencil_tables_from_jax(L.sz_np, L.sy_np, L.sx_np, L.bz_np, L.by_np, L.bx_np, p, L.real_shape)
    got = st.stencil_tables_np(pt.BrickMesh(n_el, upper=UPPER), pt.Basis1D.make(p), phys, faces)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-14 * max(1.0, np.abs(want[k]).max()), err_msg=k)


@needs_jax
@pytest.mark.parametrize("kind", ["stiffness", "mass"])
@pytest.mark.parametrize("n_el,p,phys,faces", _shard_cases()[::3])
def test_banded_shard_tables_equal_jax_layout(n_el, p, phys, faces, kind):
    L = BandedLayout(JMesh(n_el, upper=UPPER), JBasis.make(p, p + 2, "gauss"), jnp.float64, kind=kind,
                     phys_elems=phys, faces=faces)
    want = banded_tables_from_jax(L)
    got = bd.banded_tables_np(pt.BrickMesh(n_el, upper=UPPER), pt.Basis1D.make(p, p + 2, "gauss"), kind, None,
                              phys, faces)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-14 * max(1.0, np.abs(want[k]).max()), err_msg=k)


def _host_combine(part, partials, ident_global, u_global):
    """The ranks' partial sums added on the global grid (what halo_combine
    does across ranks), the global identity rows set to u."""
    acc = np.zeros(part.global_grid_shape)
    for r, blk in enumerate(partials):
        off = part.offsets(*part.coords(r))
        dst, src = [], []
        for o, nl, ng in zip(off, part.local_grid_shape, part.global_grid_shape):
            ln = max(0, min(nl, ng - o))
            dst.append(slice(o, o + ln))
            src.append(slice(0, ln))
        acc[tuple(dst)] += blk[tuple(src)]
    acc[ident_global] = u_global[ident_global]
    return acc


PARTITIONS = [((3, 5, 7), 2, (2, 2)), ((2, 4, 5), 3, (3, 1)), ((3, 3, 4), 1, (2, 2)), ((2, 5, 9), 2, (4, 2)),
              ((2, 3, 2), 5, (2, 2))]


def _partials(part, ug, make):
    """Every rank's partials of one apply (identity rows zeroed): ``make(iz,
    iy)`` gives (apply, ident)."""
    out = []
    for r in range(part.n_shards):
        iz, iy, _ = part.coords(r)
        apply, ident = make(iz, iy)
        o = apply(torch.tensor(part.block(ug, r))).numpy().copy()
        o[st.identity_mask(o.shape, ident, "cpu").numpy()] = 0.0
        out.append(o)
    return out


@pytest.mark.parametrize("n_el,p,shards", PARTITIONS)
def test_k1_shard_partials_sum_to_global_apply(n_el, p, shards):
    mesh = pt.BrickMesh(n_el, upper=UPPER)
    part = BlockPartition(mesh, p, *shards)
    basis = pt.Basis1D.make(p)
    ug = np.random.default_rng(0).standard_normal(part.global_grid_shape)
    gt = st.StencilTables.create(mesh, basis, torch.float64, "cpu")
    want = st.stencil_apply(torch.tensor(ug), gt).numpy()

    def make(iz, iy):
        t = st.StencilTables.from_numpy(
            st.stencil_tables_np(part.local_mesh, basis, part.phys_elems(iz, iy), part.faces(iz, iy)), p,
            torch.float64, "cpu", ident=part.ident(iz, iy))
        return (lambda u: st.stencil_apply(u, t)), t.identity

    gid = st.face_mask(part.global_grid_shape, "cpu").numpy()
    got = _host_combine(part, _partials(part, ug, make), gid, ug)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["stiffness", "mass"])
@pytest.mark.parametrize("n_el,p,shards", PARTITIONS)
def test_k2_shard_partials_sum_to_global_apply(n_el, p, shards, kind):
    mesh = pt.BrickMesh(n_el, upper=UPPER)
    part = BlockPartition(mesh, p, *shards)
    basis = pt.Basis1D.make(p, p + 2, "gauss")
    ug = np.random.default_rng(1).standard_normal(part.global_grid_shape)
    gt = bd.BandedTables.create(mesh, basis, torch.float64, "cpu", kind=kind)
    want = bd.banded_apply(torch.tensor(ug), gt).numpy()

    def make(iz, iy):
        phys, faces = part.phys_elems(iz, iy), part.faces(iz, iy)
        t = bd.BandedTables.from_numpy(
            bd.banded_tables_np(part.local_mesh, basis, kind, None, phys, faces), p, torch.float64, "cpu",
            element=bd.element_tables_np(part.local_mesh, basis, kind, None, phys), ident=part.ident(iz, iy))
        return (lambda u: bd.banded_apply(u, t)), t.identity

    gid = st.face_mask(part.global_grid_shape, "cpu").numpy()
    got = _host_combine(part, _partials(part, ug, make), gid, ug)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_k2_dead_elements_have_zero_factors():
    basis = pt.Basis1D.make(2, 4, "gauss")
    el = bd.element_tables_np(pt.BrickMesh((2, 3, 4)), basis, "stiffness", None, (2, 2, 1))
    assert np.all(el["ey"][:, 2:] == 0) and np.all(el["ez"][:, 1:] == 0)
    assert np.all(el["ey"][:, :2] != 0) and np.all(el["ez"][:2, :1] != 0)


@pytest.mark.parametrize("cls", ["stencil", "stencil-helmholtz", "banded", "separable", "structured", "gather", "general"])
def test_dist_operator_partials_sum_to_global_apply(cls):
    """The distributed operators' applies without exchange (one rank's
    view, ``coords=``) hold partial sums on shared planes that add up to the
    single-device apply (identity rows: the input)."""
    n_el, p, shards = (3, 5, 7), 2, (2, 2)
    mesh = pt.BrickMesh(n_el, upper=UPPER)
    part = BlockPartition(mesh, p, *shards)
    ug = np.random.default_rng(2).standard_normal(part.global_grid_shape)
    gid = st.face_mask(part.global_grid_shape, "cpu").numpy()
    ug[gid] = 0.0  # the constrained rows of an iterate are 0 at the walls of the global grid
    if cls.startswith("stencil"):
        op_name = "helmholtz" if cls.endswith("helmholtz") else "poisson"
        gop_cls = pt.HelmholtzOperator if op_name == "helmholtz" else pt.PoissonOperator
        gs = pt.FESpace.create(mesh, p, dtype=torch.float64, device="cpu")
        want = gop_cls(gs, backend="stencil").vmult(torch.tensor(ug.reshape(-1))).numpy().reshape(ug.shape)

        def make(iz, iy):
            d = DistStencilOperator(part, None, torch.float64, operator=op_name, coords=(iz, iy, 0), device="cpu")
            return d.vmult, d.tables.identity
    elif cls == "banded":
        gs = pt.FESpace.create(mesh, p, n_q=p + 2, rule="gauss", dtype=torch.float64, device="cpu")
        want = pt.PoissonOperator(gs, backend="banded").vmult(torch.tensor(ug.reshape(-1))).numpy().reshape(ug.shape)

        def make(iz, iy):
            d = DistBandedOperator(part, None, torch.float64, coords=(iz, iy, 0), device="cpu")
            return d.vmult, d.tables.identity
    else:
        rule, n_q = ("gauss_lobatto", None) if cls == "separable" else ("gauss", p + 2)
        gs = pt.FESpace.create(mesh, p, n_q=n_q, rule=rule, dtype=torch.float64, device="cpu")
        want = pt.PoissonOperator(gs, backend="structured").vmult(torch.tensor(ug.reshape(-1))).numpy()
        want = want.reshape(ug.shape)

        def make(iz, iy):
            d = DistOperator(part, None, pt.PoissonOperator, torch.float64, backend=cls, rule=rule, n_q=n_q,
                             coords=(iz, iy, 0), device="cpu")
            return d.vmult, part.ident(iz, iy)
    got = _host_combine(part, _partials(part, ug, make), gid, ug)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@needs_jax
@pytest.mark.parametrize("axis,side", [(0, 0), (0, -1), (1, 0), (1, -1), (2, 0), (2, -1)])
@pytest.mark.parametrize("rule", ["gauss_lobatto", "gauss"])
def test_apply_separable_plane_equals_jax(axis, side, rule):
    n_el, p = (3, 4, 2), 3
    n_q = None if rule == "gauss_lobatto" else p + 2
    jmesh, tmesh = JMesh(n_el, upper=UPPER), pt.BrickMesh(n_el, upper=UPPER)
    jterms = jsep.poisson_terms(jmesh, JBasis.make(p, n_q, rule), jnp.float64)
    tterms = poisson_terms(tmesh, pt.Basis1D.make(p, n_q, rule), torch.float64, "cpu")
    u = np.random.default_rng(3).standard_normal(tuple(m * p + 1 for m in n_el[::-1]))
    want = np.asarray(jsep.apply_separable_plane(jnp.asarray(u), jterms, axis, side))
    got = apply_separable_plane(torch.tensor(u), tterms, axis, side).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    # and it is the full apply's plane
    full = apply_separable(torch.tensor(u), tterms).numpy()
    np.testing.assert_allclose(got, np.take(full, [0 if side == 0 else -1], axis=axis), rtol=0,
                               atol=1e-13 * np.abs(want).max())


@needs_jax
@pytest.mark.parametrize("value", [False, True])
@pytest.mark.parametrize("axis,side", [(0, 0), (0, -1), (1, 0), (1, -1)])
@pytest.mark.parametrize("n_el,p,phys,faces", [((2, 3, 4), 2, (2, 3, 4), (False, False, True, False)),
                                               ((2, 3, 3), 3, (2, 2, 3), (True, False, False, True))])
def test_k1_plane_partial_equals_jax_stencil_plane_padded(n_el, p, phys, faces, axis, side, value):
    L = StencilLayout(JMesh(n_el, upper=UPPER), JBasis.make(p), jnp.float64, phys_elems=phys, faces=faces)
    nz, ny, nx = L.real_shape
    rng = np.random.default_rng(4)
    u = rng.standard_normal((nz, ny, nx))
    a = 0.5 + rng.random((nz, ny, nx)) if value else None
    upad = np.zeros(L.padded_shape)
    upad[p:p + nz, JAX_STENCIL_YOFF:JAX_STENCIL_YOFF + ny, :nx] = u
    row = ((p, p + nz - 1) if axis == 0 else (JAX_STENCIL_YOFF, JAX_STENCIL_YOFF + ny - 1))[side]
    want = np.asarray(stencil_plane_padded(jnp.asarray(upad), L.bz, L.by, L.bx, L.sz, L.syx,
                                           None if a is None else L.pad_node_field(a), L, axis, row))
    want = want[JAX_STENCIL_YOFF:JAX_STENCIL_YOFF + ny, :nx] if axis == 0 else want[p:p + nz, :nx]
    tabs = st.stencil_tables_np(pt.BrickMesh(n_el, upper=UPPER), pt.Basis1D.make(p), phys, faces)
    if value:
        tabs["a"] = a
    t = st.StencilTables.from_numpy(tabs, p, torch.float64, "cpu", ident=(0, nz, 0, ny, 1, nx - 1))
    got = st.plane_partial(torch.tensor(u), t, axis, side).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    # and it is the raw apply's plane
    t.ident = (0, nz, 0, ny, 0, nx)
    full = st.stencil_apply(torch.tensor(u), t).numpy()
    np.testing.assert_allclose(got, np.take(full, 0 if side == 0 else -1, axis=axis), rtol=0,
                               atol=1e-13 * np.abs(want).max())


def test_shard_mode_checks():
    t = st.StencilTables.create(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(2), torch.float64, "cpu")
    t.ident = (0, 5, 0, 5, 1, 4)
    with pytest.raises(ValueError, match="one component"):
        st.stencil_apply(torch.zeros((2, 5, 5, 5), dtype=torch.float64), t)
    t.ident = (0, 5)
    with pytest.raises(ValueError, match="six ints"):
        st.stencil_apply(torch.zeros((5, 5, 5), dtype=torch.float64), t)
    with pytest.raises(ValueError, match="ident"):
        bd.BandedTables.from_numpy(
            bd.banded_tables_np(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(2, 4, "gauss")), 2, torch.float64, "cpu",
            ident=(0, 5, 0, 5, 0, 5))
    with pytest.raises(ValueError, match="dead elements"):
        st.stencil_tables_np(pt.BrickMesh((2, 2, 3)), pt.Basis1D.make(2), (2, 2, 2), (True, False, True, True))


def test_k5_refuses_shard_tables():
    from deal_and_ceed_on_gpu_torch.ops.cg import CGFusedStep

    t = st.StencilTables.create(pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(2), torch.float64, "cpu")
    CGFusedStep(t)
    t.ident = (0, 5, 1, 4, 1, 4)
    with pytest.raises(ValueError, match="shard"):
        CGFusedStep(t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's and K2's shard modes are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("n_el,p,phys,faces", _shard_cases()[::2])
def test_shard_mode_on_card_matches_plain(cuda_device, kernel, n_el, p, phys, faces):
    """The CUDA shard modes against their plain versions (f64, from a
    NaN-filled output; identity rows bitwise)."""
    mesh = pt.BrickMesh(n_el, upper=UPPER)
    nz, ny, nx = (m * p + 1 for m in n_el[::-1])
    ident = (int(faces[0]), phys[2] * p if faces[1] else nz, int(faces[2]), phys[1] * p if faces[3] else ny, 1, nx - 1)
    if kernel == "K1":
        t = st.StencilTables.from_numpy(st.stencil_tables_np(mesh, pt.Basis1D.make(p), phys, faces), p,
                                        torch.float64, cuda_device, ident=ident)
        apply, ref = st.stencil_apply, st.stencil_apply_reference
    else:
        basis = pt.Basis1D.make(p, p + 2, "gauss")
        t = bd.BandedTables.from_numpy(bd.banded_tables_np(mesh, basis, "stiffness", None, phys, faces), p,
                                       torch.float64, cuda_device,
                                       element=bd.element_tables_np(mesh, basis, "stiffness", None, phys), ident=ident)
        apply, ref = bd.banded_apply, bd.banded_apply_reference
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(t.shape), device=cuda_device)
    got = apply(u, t, out=torch.full_like(u, float("nan")))
    want = ref(u, t)
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    idm = st.identity_mask(t.shape, ident, cuda_device)
    assert torch.equal(got[idm], u[idm])


@pytest.mark.parametrize("axis,side", [(0, 0), (0, -1), (1, 0), (1, -1)])
def test_plane_slab_is_the_raw_apply_on_the_p_plus_1_planes(axis, side):
    """``plane_slab``: the (p+1)-plane slab next to the plane, at the compute
    dtype (bf16 vectors: f32), with the slab's rows of the tables and no
    identity row; the plane partial is the slab's apply at that plane."""
    p, n_el, phys, faces = 2, (2, 3, 4), (2, 2, 4), (True, False, False, True)
    t = st.StencilTables.from_numpy(st.stencil_tables_np(pt.BrickMesh(n_el, upper=UPPER), pt.Basis1D.make(p), phys,
                                                         faces), p, torch.float32, "cpu")
    u = torch.as_tensor(np.random.default_rng(8).standard_normal(t.shape), dtype=torch.bfloat16)
    slab, sub = st.plane_slab(u, t, axis, side)
    n = t.shape[axis]
    lo = 0 if side == 0 else n - (p + 1)
    assert slab.dtype == torch.float32 and slab.shape[axis] == p + 1
    assert torch.equal(slab, u.narrow(axis, lo, p + 1).float())
    name_b, name_s = ("bz", "sz") if axis == 0 else ("by", "sy")
    assert torch.equal(getattr(sub, name_b), getattr(t, name_b)[lo:lo + p + 1])
    assert torch.equal(getattr(sub, name_s), getattr(t, name_s)[lo:lo + p + 1])
    assert st.identity_mask(sub.shape, sub.identity, "cpu").sum() == 0
    got = st.plane_partial(u, t, axis, side)
    assert torch.equal(got, st.stencil_apply(slab, sub).select(axis, 0 if side == 0 else p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("n_el,p,phys,faces", _shard_cases()[::3])
def test_plane_partial_on_card_matches_plain(cuda_device, dtype, n_el, p, phys, faces):
    """K1's plane partials on the card (K1 raw on slabs one element thick)
    against the matching planes of the plain raw apply on the whole block,
    and each slab's launch from a NaN-filled output against its plain
    version (f64 1e-13, f32 and bf16 vectors 1e-5: the slab is f32)."""
    import dataclasses

    mesh = pt.BrickMesh(n_el, upper=UPPER)
    cd = torch.float64 if dtype == "float64" else torch.float32
    t = st.StencilTables.from_numpy(st.stencil_tables_np(mesh, pt.Basis1D.make(p), phys, faces), p, cd, cuda_device)
    u = torch.as_tensor(np.random.default_rng(6).standard_normal(t.shape), dtype=cd, device=cuda_device)
    u = u.to(getattr(torch, dtype))
    nz, ny, nx = t.shape
    want = st.apply_plain(u.to(cd), dataclasses.replace(t, ident=(0, nz, 0, ny, 0, nx))).double()
    tol = (1e-13 if cd == torch.float64 else 1e-5) * float(want.abs().max())
    for axis in (0, 1):
        for side in (0, -1):
            slab, sub = st.plane_slab(u, t, axis, side)
            got = st.stencil_apply(slab, sub, out=torch.full_like(slab, float("nan")))
            assert float((got.double() - st.apply_plain(slab, sub).double()).abs().max()) <= tol
            plane = st.plane_partial(u, t, axis, side)
            assert float((plane.double() - want.select(axis, 0 if side == 0 else t.shape[axis] - 1)).abs().max()) <= tol


@pytest.mark.parametrize("cls", ["operator", "stencil", "banded"])
def test_rank_operator_defaults_to_cuda_and_raises_without_a_card(monkeypatch, cls):
    """With no comm and no device a rank's operator is built on ``cuda``:
    without a card it raises and never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    part = BlockPartition(pt.BrickMesh((2, 2, 4)), 2, 2)
    make = {"operator": lambda: DistOperator(part, None, coords=(0, 0, 0)),
            "stencil": lambda: DistStencilOperator(part, None, torch.float64, coords=(0, 0, 0)),
            "banded": lambda: DistBandedOperator(part, None, torch.float64, coords=(0, 0, 0))}[cls]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_init_shards_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    """``init_shards`` with gloo and no device takes a card (``LOCAL_RANK``
    modulo the card count): without one it raises before joining a group."""
    from deal_and_ceed_on_gpu_torch.parallel import init_shards

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_shards(1, backend="gloo")
