"""K3 with bf16 coefficient planes (ops/qgrid.py, coef_dtype=torch.bfloat16)
against the JAX layout's bf16 coefficient stream
(QGridLayout(coef_stream_dtype=jnp.bfloat16)): the tables bitwise, the
plain version against the JAX kernel in interpret mode (f32 vectors,
diag3 and full6 with a value table, raw and constrained, after
fold_scale), and the refused pairing of f64 vectors with bf16 planes."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_qgrid import _make
from test_torch_qgrid import _specs

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.ops import qgrid as qg
from deal_and_ceed_on_gpu_torch.utils.convert import qgrid_tables_from_jax
from deal_and_ceed_on_gpu_tpu import FESpace
from deal_and_ceed_on_gpu_tpu.ops.pallas_qgrid import build_qgrid_operator

TOL = 1e-5  # f32 vectors: of max|want|
# (mesh kind, elements, p, q - p - 1, grad, val) in tests/test_pallas_qgrid.py's terms
CASES = [
    ("mapped", (2, 3, 2), 2, 1, "grad", "dettab"),  # full6 + value table
    ("graded", (3, 2, 2), 3, 0, "grad", "table"),  # diag3 + value table
]
IDS = ["mapped-full6", "graded-diag3"]


@functools.cache
def _jax_case(i):
    """The JAX operator with bf16 planes (f32 vectors) and its specs."""
    kind, shape, p, qoff, grad, val = CASES[i]
    mesh = _make(kind, shape)
    space = FESpace.create(mesh, p, n_q=p + 1 + qoff, rule="gauss", dtype=jnp.float64)
    specs = _specs(space.geometry, grad, val)
    qop = build_qgrid_operator(mesh, space.basis, jnp.float32, grad=specs[0], val=specs[1], interpret=True,
                               coef_stream_dtype=jnp.bfloat16)
    return space, qop, specs


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_bf16_tables_equal_the_jax_layouts(case):
    """Carried across (utils/convert) and built by the port from the same
    specs, the planes are the JAX layout's bf16 values, bit for bit."""
    space, qop, specs = _jax_case(case)
    L = qop.layout
    tabs = qgrid_tables_from_jax(L)
    assert tabs["coef_dtype"] == "bfloat16"
    carried = qg.QGridTables.from_numpy(tabs, torch.float32, device="cpu")
    mx, my, mz = L.mesh.n_elements
    real = (slice(0, mz * L.q), slice(0, my * L.q), slice(0, mx * L.q))
    kind, shape, p, qoff, _, _ = CASES[case]
    own = qg.QGridTables.create(pt.BrickMesh(shape), pt.Basis1D.make(p, p + 1 + qoff, "gauss"), torch.float32,
                                *specs, device="cpu", coef_dtype=torch.bfloat16)
    for t in (carried, own):
        assert t.coef_dtype == torch.bfloat16 and t.C.dtype == torch.bfloat16 and t.a_q.dtype == torch.bfloat16
        # bf16 -> f32 is exact: compare the widened bits
        np.testing.assert_array_equal(t.C.float().numpy().view(np.int32),
                                      np.asarray(L.C[(slice(None),) + real], dtype=np.float32).view(np.int32))
        np.testing.assert_array_equal(t.a_q.float().numpy().view(np.int32),
                                      np.asarray(L.a_q[real], dtype=np.float32).view(np.int32))


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_plain_version_matches_jax_interpret(case, constrained):
    space, qop, _ = _jax_case(case)
    L = qop.layout
    tables = qg.QGridTables.from_numpy(qgrid_tables_from_jax(L), torch.float32, device="cpu")
    u = np.random.default_rng(case).standard_normal(space.n_dofs).astype(np.float32)
    up = L.pad_flat(jnp.asarray(u))
    want = np.asarray(L.unpad_flat(qop.constrained_call(up) if constrained else qop(up)))
    ut = torch.as_tensor(u).reshape(tables.shape)
    got = qg.qgrid_apply_reference(ut, tables, constrained).reshape(-1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(qg.qgrid_apply(ut, tables, constrained).reshape(-1).numpy(), got)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_fold_scale_multiplies_in_bf16_as_jax_does(case):
    """fold_scale rescales the bf16 planes in their own dtype: the same bits
    as the JAX layout's ``C * s``, and the applies still agree."""
    _, qop, _ = _jax_case(case)
    L = qop.layout
    tables = qg.QGridTables.from_numpy(qgrid_tables_from_jax(L), torch.float32, device="cpu")
    s = 0.0123456789
    C, a_q = L.C * s, L.a_q * s  # the JAX layout's fold_scale, without changing the cached layout
    assert C.dtype == jnp.bfloat16
    before = tables.C
    tables.fold_scale(s)
    assert tables.C is before  # in place: the tensor the kernel reads
    mx, my, mz = L.mesh.n_elements
    real = (slice(0, mz * L.q), slice(0, my * L.q), slice(0, mx * L.q))
    np.testing.assert_array_equal(tables.C.float().numpy().view(np.int32),
                                  np.asarray(C[(slice(None),) + real], dtype=np.float32).view(np.int32))
    np.testing.assert_array_equal(tables.a_q.float().numpy().view(np.int32),
                                  np.asarray(a_q[real], dtype=np.float32).view(np.int32))
    u = np.random.default_rng(7).standard_normal(int(np.prod(tables.shape))).astype(np.float32)
    want = np.asarray(L.unpad_flat(qop.apply_tables(L.pad_flat(jnp.asarray(u)), (C, a_q, qop._consts()))))
    got = qg.qgrid_apply_reference(torch.as_tensor(u).reshape(tables.shape), tables).reshape(-1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_f64_vectors_with_bf16_planes_are_refused():
    mesh, basis = pt.BrickMesh((2, 2, 2)), pt.Basis1D.make(2, 3, "gauss")
    cells = (mesh.n_cells, 27)
    tabs = qg.qgrid_tables_np(mesh, basis, grad=("diag3", np.ones(cells + (3,))), val=("table", np.ones(cells)))
    with pytest.raises(ValueError, match="f32/bf16"):
        qg.QGridTables.from_numpy(tabs, torch.float64, device="cpu", coef_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32/bf16"):
        qg.QGridTables.from_numpy(tabs, torch.float32, device="cpu", coef_dtype=torch.float64)
    space = pt.FESpace.create(mesh, 2, n_q=3, rule="gauss", dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="f32/bf16"):
        pt.PoissonOperator(space, backend="qgrid", coef_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="qgrid"):
        pt.PoissonOperator(space, backend="general", coef_dtype=torch.bfloat16)
    # planes of another dtype than the tables say are refused at the apply
    t = qg.QGridTables.from_numpy(tabs, torch.float32, device="cpu", coef_dtype="bfloat16")
    t.C = t.C.float()
    with pytest.raises(ValueError, match="bfloat16"):
        qg.qgrid_apply(torch.zeros(t.shape), t)


def test_bf16_planes_stay_within_bf16_rounding_of_f32_planes():
    """The port's operator with bf16 planes (the bench_general path) against
    the same operator with f32 planes: bf16 rounding of the coefficients
    only (8e-3 of max|out|, the card's gate)."""
    space = pt.FESpace.create(pt.BrickMesh((3, 3, 3)).deform(*pt.sine_map(0.05)), 3, n_q=4, rule="gauss",
                              dtype=torch.float32, device="cpu")
    wide = pt.PoissonOperator(space, backend="qgrid")
    narrow = pt.PoissonOperator(space, backend="qgrid", coef_dtype=torch.bfloat16)
    assert narrow._qgrid.C.dtype == torch.bfloat16 and narrow._qgrid.C.shape == wide._qgrid.C.shape
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(space.n_dofs), dtype=torch.float32)
    a, b = narrow.vmult(u), wide.vmult(u)
    rel = float((a - b).abs().max() / b.abs().max())
    assert 0 < rel <= 8e-3
