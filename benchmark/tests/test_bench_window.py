"""The window's arithmetic: a rate is all the work over all the time."""

import pytest

from benchmark.system import RunData, Unit


def _data(tiny_cell, name, units, window_s):
    from benchmark.system import kernel_ctx

    cell = tiny_cell(name)
    d = RunData(cell, kernel_ctx(cell), 12.5)
    d.units, d.window_s = units, window_s
    return d


def _read(name, data):
    from benchmark.system import metric_reader

    return metric_reader(name)(data)


def test_solve_rate_takes_every_solve(tiny_cell):
    units = [Unit(0.1, 200)] * 95 + [Unit(1.0, 200)] * 5 + [Unit(0.1, 200, "profiled")]
    d = _data(tiny_cell, "bp5_c40_f64_cg", units, 16.0)
    assert _read("solve_s", d) == pytest.approx(16.0 / 101)  # the window's time, stalls and all
    assert _read("iterations", d) == 200.0
    # iter_ms takes the units before the stretch
    assert _read("iter_ms", d) == pytest.approx(1e3 * (95 * 0.1 + 5 * 1.0) / (100 * 200))
    assert _read("vmult_gdofs", d) is None and _read("setup_s", d) == 12.5


def test_vmult_rate(tiny_cell):
    d = _data(tiny_cell, "bp5_c40_f32_vmult", [Unit(0.03, 200)] * 10, 0.35)
    assert _read("vmult_gdofs", d) == pytest.approx(d.ctx["n"] * 2000 / 0.35 / 1e9)
    assert _read("solve_s", d) is None


def test_readers_of_the_trace(tiny_cell):
    from benchmark import roofline

    d = _data(tiny_cell, "bp5_c40_f64_cg", [Unit(0.5, 200)] * 4 + [Unit(0.6, 200, "profiled")] * 2, 3.2)
    d.stretch_units = 2
    d.stretch = {"busy_s": 0.9, "window_s": 1.2, "kernels": {"K1": (400, 0.2), "K7": (402, 0.3), "K8": (402, 0.1)},
                 "device_ops": [], "idle_gaps": []}
    k1 = roofline.kernel("K1").bound_s(d.ctx, 400, 2)
    assert _read("apply_roofline", d) == pytest.approx(100 * k1 / 0.2)
    assert _read("apply_roofline.vmult", d) == _read("apply_roofline", d)  # a split name reads its base
    k78 = roofline.kernel("K7").bound_s(d.ctx, 402, 2) + roofline.kernel("K8").bound_s(d.ctx, 402, 2)
    assert _read("cg_kernels_roofline", d) == pytest.approx(100 * k78 / 0.4)
    assert _read("device_idle", d) == pytest.approx(25.0)
    assert _read("step_roofline", d) == pytest.approx(100 * d.unit_bound_s(200) / 0.5)
    d.stretch["kernels"].pop("K8")
    assert _read("cg_kernels_roofline", d) is None  # a kernel the stretch never ran: nothing to read, never 0
