"""The readers of the program's spans and counters (``k7_host_us``, ``k8_host_us``, ``vmult_host_us``,
``host_syncs``): their arithmetic on a faked record, nothing where nothing was recorded, and finite
values from a short traced run of a solve cell on the CPU."""

import copy
import math

import pytest

from benchmark.system import RunData, Unit, kernel_ctx, metric_reader, run

READERS = ("k7_host_us", "k8_host_us", "vmult_host_us", "host_syncs")


def _data(tiny_cell, units, stretch=True):
    cell = tiny_cell("bp5_c40_f64_cg")
    d = RunData(cell, kernel_ctx(cell), 12.5)
    d.units = units
    if stretch:
        d.stretch = {"busy_s": 0.9, "window_s": 1.2, "kernels": {}, "device_ops": [], "idle_gaps": []}
        d.stretch_units = sum(u.phase == "profiled" for u in units)
    return d


def _fake(monkeypatch, record):
    from deal_and_ceed_on_gpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recorded", lambda: copy.deepcopy(record))


def _span(calls, total_ns, parent="cg.solve"):
    return {"calls": calls, "total_ns": total_ns, "self_ns": total_ns, "parent": parent}


def test_readers_arithmetic(tiny_cell, monkeypatch):
    units = [Unit(0.5, 200)] * 3 + [Unit(0.6, 200, "profiled"), Unit(0.6, 180, "profiled"), Unit(0.5, 200, "after")]
    _fake(monkeypatch, {"spans": {"cg.update": _span(380, 380 * 12_500), "cg.dots": _span(380, 3_990_000),
                                  "op.vmult": _span(380, 380 * 99_000, "cg.apply")},
                        "counts": {"host_syncs": 2 * 3 + 380}})
    d = _data(tiny_cell, units)
    assert metric_reader("k7_host_us")(d) == pytest.approx(12.5)
    assert metric_reader("k8_host_us")(d) == pytest.approx(3_990_000 / 380 / 1e3)
    assert metric_reader("vmult_host_us")(d) == pytest.approx(99.0)
    # per iteration of the profiled solves alone: 200 + 180
    assert metric_reader("host_syncs")(d) == pytest.approx(386 / 380)


def test_nothing_recorded_reads_nothing(tiny_cell, monkeypatch):
    units = [Unit(0.5, 200), Unit(0.6, 200, "profiled")]
    _fake(monkeypatch, {"spans": {}, "counts": {}})
    for name in READERS:
        assert metric_reader(name)(_data(tiny_cell, units)) is None, name
    # no stretch: nothing to read, whatever was recorded
    _fake(monkeypatch, {"spans": {"cg.update": _span(1, 10)}, "counts": {"host_syncs": 1}})
    for name in READERS:
        assert metric_reader(name)(_data(tiny_cell, units, stretch=False)) is None, name
    # a program with no recorder (the parent of the spans) reads nothing and raises nothing
    from deal_and_ceed_on_gpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    for name in READERS:
        assert metric_reader(name)(_data(tiny_cell, units)) is None, name


@pytest.mark.parametrize("name,elements", [("bp5_c40_f64_cg", [4, 4, 2]), ("step64_r7_f64_cg", [4, 4, 4])])
def test_traced_run_on_the_cpu(name, elements, tiny_cell):
    from deal_and_ceed_on_gpu_torch.utils import profiling

    cell = tiny_cell(name)
    cell.config["mesh"]["n_elements"] = elements
    profiling.reset()
    try:
        data, _, _, _ = run(cell, 2**31 + 29, 0.2, True, "cpu", 0.0)
        iterations = sum(u.work for u in data.units if u.phase == "profiled")
        spans = profiling.recorded()["spans"]
        # the stretch alone: the profiler's warm-up apply and the units outside it are not recorded
        assert spans["op.vmult"]["calls"] == spans["cg.update"]["calls"] == iterations > 0
        assert spans["cg.solve"]["calls"] == data.stretch_units == 2
        values = {m: metric_reader(m)(data) for m in READERS}
    finally:
        profiling.reset()
    for m, v in values.items():
        assert v is not None and math.isfinite(v) and v > 0, (m, v)
    # one residual read an iteration, one of res0 and two in the check a solve
    assert values["host_syncs"] == pytest.approx((iterations + 3 * 2) / iterations)
