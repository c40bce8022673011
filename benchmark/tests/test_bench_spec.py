"""BENCHMARK.json against the contract's shape, and every name resolving to its files."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # 24 cells measured in full fit in 12 hours: 2 + 14 runs a cell of run_seconds + 60 s, 180 s a cell to build, 1200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and 0 < len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 0 < len(w["why"]) <= 200 and "\n" not in w["why"]
    for section in ("end_to_end", "per_layer"):
        for m in SPEC[section]:
            keys = {"name", "unit", "better", "source"} | ({"bound"} if section == "end_to_end" else
                                                           {"layer", "moves"})
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["name"] not in seen
            seen.add(m["name"])
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)


def test_every_name_resolves_to_its_files():
    from benchmark import roofline
    from benchmark.system import load_cell, metric_reader

    for name in CELLS:
        cell = load_cell(name)
        assert (BENCH / "workloads" / f"{cell.entry['traffic']}.json").is_file()
        assert (BENCH / "kinds" / f"{cell.traffic['kind']}.py").is_file()
        for fn in ("make_inputs", "make_unit", "reference_units", "numbers"):
            assert callable(getattr(cell.kind, fn)), (name, fn)
        assert cell.limits, name
        for label in cell.labels:
            assert callable(roofline.kernel(label).bound_s)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(metric_reader(m["name"]))
    for c in SPEC["configs"]:
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    from benchmark.system import load_cell

    c = load_cell(cell)
    e2e = {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = c.metrics("per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_per_layer_moves_an_end_to_end_metric_and_layers_are_named_alike():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in CELLS
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
    assert {m["layer"] for m in SPEC["per_layer"]} <= {"solver", "operator", "kernels", "device"}


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_a_configurations_stated_sizes_are_its_mesh(name):
    # dofs is documentation, held to what the geometry gives
    from benchmark.system import geometry

    cfg = json.loads((ROOT / next(c["file"] for c in SPEC["configs"] if c["name"] == name)).read_text())
    assert cfg["name"] == name
    assert cfg["dofs"] == geometry(cfg["geometry"]).n_dofs(cfg)


@pytest.mark.parametrize("key, value", [("geometry", "no_such_geometry"), ("preconditioner", "no_such_preconditioner")])
def test_what_neither_side_supports_is_refused(key, value, tiny_cell):
    # a configuration's geometry and preconditioner reach the program and the
    # reference through one loader each; a name with no file stops the run
    import copy

    from benchmark.system import build_program, preconditioner, reference_operator, run

    cell = tiny_cell("bp5_c40_f64_cg")
    cell.config = {**copy.deepcopy(cell.config), key: value}
    with pytest.raises(ValueError, match=value):
        run(cell, 1, 0.0, False, "cpu", 0.0)
    if key == "geometry":
        with pytest.raises(ValueError, match=value):
            reference_operator(cell.config)
        with pytest.raises(ValueError, match=value):
            build_program(cell, 1.0, "cpu")
    else:
        with pytest.raises(ValueError, match=value):
            preconditioner(value)
