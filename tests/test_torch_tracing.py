"""The port's spans and counters (``utils/profiling``: ``span``, ``count``,
``recorded``, ``reset``, ``record``) on the CPU: off they record nothing and
enter no record function; under ``torch.profiler`` (past its warm-up
step) or ``record()`` a merged-CG solve records one ``cg.apply``,
``cg.dots``, ``cg.stop_test``, ``cg.update`` and ``op.vmult`` an iteration
under ``cg.solve``, and one ``host_syncs`` a host read of a device value."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.utils import profiling

ITERATIONS = 6
LOOP = ("cg.apply", "cg.dots", "cg.stop_test", "cg.update")


@pytest.fixture(autouse=True)
def clean_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _problem(backend="stencil"):
    space = pt.FESpace.create(pt.BrickMesh((3, 3, 2)), 3, dtype=torch.float64, device="cpu")
    op = pt.PoissonOperator(space, backend=backend)
    b = torch.randn(space.n_dofs, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    return op, b


def _solve(op, b, deferred=False):
    control = pt.IterationNumberControl(ITERATIONS, 0.0)
    x, info = pt.solve_cg_merged(op.vmult, b, control, deferred_x_update=deferred)
    control.check(info)
    return x, info


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "HOST_EVENT", refuse)


def _check_solve_record(rec, iterations):
    spans = rec["spans"]
    assert spans["cg.solve"]["calls"] == 1 and spans["cg.solve"]["parent"] is None
    assert spans["cg.init"]["calls"] == 1 and spans["cg.init"]["parent"] == "cg.solve"
    for name in LOOP:
        assert spans[name]["calls"] == iterations and spans[name]["parent"] == "cg.solve", name
    assert spans["op.vmult"]["calls"] == iterations and spans["op.vmult"]["parent"] == "cg.apply"
    for name, s in spans.items():
        assert 0 <= s["self_ns"] <= s["total_ns"], name
    # the solve's self time is what its children leave: init and the loop's spans lie inside it
    inside = sum(spans[n]["total_ns"] for n in ("cg.init", *LOOP))
    assert spans["cg.solve"]["self_ns"] == spans["cg.solve"]["total_ns"] - inside
    assert spans["cg.apply"]["self_ns"] == spans["cg.apply"]["total_ns"] - spans["op.vmult"]["total_ns"]
    # res0 and one residual an iteration in the solve, res_norm and res0 in check
    assert rec["counts"] == {"host_syncs": iterations + 1 + 2}


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    op, b = _problem()
    _no_record_function(monkeypatch)
    assert profiling.span("cg.update") is profiling.span("op.vmult")  # one shared no-op context
    _, info = _solve(op, b)
    assert info["n_iterations"] == ITERATIONS
    assert profiling.recorded() == {"spans": {}, "counts": {}}


@pytest.mark.parametrize("backend", ["stencil", "separable"])
@pytest.mark.parametrize("deferred", [False, True])
def test_solve_under_the_profiler(backend, deferred):
    op, b = _problem(backend)
    x_off, _ = _solve(op, b, deferred)
    with profile(activities=[ProfilerActivity.CPU]):
        x_on, info = _solve(op, b, deferred)
    assert info["n_iterations"] == ITERATIONS
    torch.testing.assert_close(x_on, x_off, rtol=0, atol=0)  # the spans change nothing of the solve
    _check_solve_record(profiling.recorded(), ITERATIONS)
    # the profiler stopped: nothing more is recorded
    before = profiling.recorded()
    _solve(op, b, deferred)
    assert profiling.recorded() == before


def test_profiler_events_carry_the_span_names():
    op, b = _problem()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(op, b)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    for name in ("cg.solve", "cg.init", *LOOP, "op.vmult"):
        assert name in names, name
    assert names.count("cg.update") == ITERATIONS and names.count("op.vmult") == ITERATIONS


def test_the_warm_up_step_records_nothing():
    """The profiler's warm-up step leaves the flag down: only the recording step counts."""
    op, b = _problem()
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        op.vmult(b)  # warm-up step
        assert profiling.recorded()["spans"] == {}
        prof.step()
        _solve(op, b)
        prof.step()
    _check_solve_record(profiling.recorded(), ITERATIONS)


def test_record_works_without_a_profiler(monkeypatch):
    op, b = _problem()
    _no_record_function(monkeypatch)  # record() alone keeps the clock, not the profiler's events
    with profiling.record():
        _solve(op, b)
    _check_solve_record(profiling.recorded(), ITERATIONS)
    with profiling.record(on=False):
        profiling.count("host_syncs")
        with profiling.span("cg.solve"):
            pass
    assert profiling.recorded()["spans"]["cg.solve"]["calls"] == 1
    assert profiling.recorded()["counts"]["host_syncs"] == ITERATIONS + 3


@pytest.mark.parametrize("under", ["record", "profiler"])
def test_a_span_that_raises_leaves_the_recorder_consistent(under):
    on = profiling.record() if under == "record" else profile(activities=[ProfilerActivity.CPU])
    with on:
        with profiling.span("outer"):
            with pytest.raises(ValueError, match="inner"):
                with profiling.span("inner"):
                    profiling.count("n", 2)
                    raise ValueError("inner")
            with profiling.span("after"):
                pass
        with profiling.span("top"):
            pass
    spans = profiling.recorded()["spans"]
    assert spans["inner"]["calls"] == 1 and spans["inner"]["parent"] == "outer"
    assert spans["after"]["parent"] == "outer" and spans["top"]["parent"] is None
    assert spans["outer"]["self_ns"] == spans["outer"]["total_ns"] - spans["inner"]["total_ns"] - \
        spans["after"]["total_ns"]
    assert profiling.recorded()["counts"] == {"n": 2}
    assert profiling._REC.open == [] and profiling._REC.forced == 0


def test_reset_clears_everything():
    with profiling.record():
        with profiling.span("a"):
            profiling.count("host_syncs", 3)
        assert profiling.recorded()["spans"]["a"]["calls"] == 1
        profiling.reset()
        assert profiling.recorded() == {"spans": {}, "counts": {}}
        with profiling.span("b"):
            pass
    assert set(profiling.recorded()["spans"]) == {"b"} and profiling.recorded()["counts"] == {}
