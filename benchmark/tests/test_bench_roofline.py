"""The frozen work counts against hand counts at small shapes."""

import pytest

from benchmark import roofline

HBM = 3.35e12


def test_bound_takes_the_larger_time():
    assert roofline.bound_s(3.35e12, 1.0, "float64") == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 34e12, "float64") == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12, "float32") == pytest.approx(1.0)


def test_k1_grid_bytes():
    # p = 2 on 4 x 2 x 2 elements: a 9 x 5 x 5 grid; u read, out written, 8 bytes each
    ctx = {"n": 225, "degree": 2, "vector_bytes": 8, "compute": "float64"}
    assert roofline.kernel("K1").bound_s(ctx, 3, 1) == pytest.approx(3 * 3600 / HBM)
    # operations: 225 (4 + 6 * 5) = 7650; at 1 byte a point the operations bound it
    ctx = {"n": 225, "degree": 2, "vector_bytes": 1e-6, "compute": "float64"}
    assert roofline.kernel("K1").bound_s(ctx, 1, 1) == pytest.approx(7650 / 34e12)


def test_k3_value_table_bytes():
    # p = 3, q = 4 on 2 x 2 x 2 elements: 343 points; one value plane of 8 x 64 numbers
    ctx = {"n": 343, "degree": 3, "n_q": 4, "n_elements": (2, 2, 2), "value_table": True, "vector_bytes": 8,
           "coef_bytes": 8, "compute": "float64"}
    assert roofline.kernel("K3").bound_s(ctx, 1, 1) == pytest.approx((2 * 343 * 8 + 8 * 64 * 8) / HBM)
    ctx["value_table"] = False
    # 8 elements x (4 (2*4*64 + 3*16*16 + 4*64*4) + 4*64) = 75,776 operations
    assert roofline.kernel("K3").bound_s(ctx, 1, 1) == pytest.approx(max(2 * 343 * 8 / HBM, 75776 / 34e12))


def test_k7_k8_vectors():
    ctx = {"n": 1000, "vector_bytes": 8, "diag_bytes": 0, "compute": "float64"}
    # two iterations' calls (7 and 3 vectors) and a solve's first call (2 and 1)
    assert roofline.kernel("K7").bound_s(ctx, 3, 1) == pytest.approx((2 * 7 + 2) * 8000 / HBM)
    assert roofline.kernel("K8").bound_s(ctx, 3, 1) == pytest.approx((2 * 3 + 1) * 8000 / HBM)
    ctx["vector_bytes"], ctx["compute"] = 2, "float32"
    assert roofline.kernel("K7").bound_s(ctx, 201, 1) == pytest.approx((200 * 7 + 2) * 2000 / HBM)


def test_k7_k8_count_a_diagonal():
    # f64 with a diagonal: an iteration's K7 reads x, g, d, h, diag and writes x, g, d (8 vectors), K8 reads
    # d, g, h, diag (4); the first calls 3 (g, diag -> d) and 1 (g)
    ctx = {"n": 1000, "vector_bytes": 8, "diag_bytes": 8, "compute": "float64"}
    assert roofline.kernel("K7").bound_s(ctx, 3, 1) == pytest.approx((2 * 8 + 3) * 8000 / HBM)
    assert roofline.kernel("K8").bound_s(ctx, 3, 1) == pytest.approx((2 * 4 + 1) * 8000 / HBM)
    # bf16 vectors with an f32 diagonal: x, d and diag at 4 bytes, g and h at 2
    ctx = {"n": 1000, "vector_bytes": 2, "diag_bytes": 4, "compute": "float32"}
    k7 = 2 * (3 * 2 + 4 * 4 + 4) + (2 + 4 + 4)  # bytes a point: two iterations' calls, a first call
    assert roofline.kernel("K7").bound_s(ctx, 3, 1) == pytest.approx(k7 * 1000 / HBM)
    assert roofline.kernel("K8").bound_s(ctx, 3, 1) == pytest.approx((2 * (2 * 2 + 4 + 4) + 2) * 1000 / HBM)


# each cell's bound_s at 201 calls in 1 unit, pinned to the last bit: what the harness counts for a cell moves
# only with a change to that cell's files or to a kernel's count
PINNED = {
    "bp5_c40_f64_cg": {"K1": 0.12661708896, "K3": 0.29457337163294117, "K7": 0.4415849719450746,
                       "K8": 0.18929569767402984},
    "step64_r7_f64_cg": {"K1": 0.05478396000000001, "K3": 0.11920846943999999, "K7": 0.19106246746268657,
                         "K8": 0.08190338298507463},
    "bp5_c40_bf16_cg": {"K1": 0.03165427224, "K3": 0.14948499456, "K7": 0.11039624298626866,
                        "K8": 0.04732392441850746},
    "bp5_c40_f32_vmult": {"K1": 0.06330854448, "K3": 0.14948499456, "K7": 0.2207924859725373,
                          "K8": 0.09464784883701492},
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_a_cells_bounds_are_pinned(name):
    from benchmark.system import kernel_ctx, load_cell

    ctx = kernel_ctx(load_cell(name))
    assert {label: roofline.kernel(label).bound_s(ctx, 201, 1) for label in PINNED[name]} == PINNED[name]


def test_a_cells_kernel_names_are_distinct():
    # the trace labels a device kernel by the first MATCH of the cell's own labels it contains
    from benchmark.system import load_cell
    from benchmark.tests.test_bench_spec import CELLS

    for name in CELLS:
        matches = [roofline.kernel(label).MATCH for label in load_cell(name).labels]
        assert len(set(matches)) == len(matches)
        assert not any(a != b and a in b for a in matches for b in matches)
