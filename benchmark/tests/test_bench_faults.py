"""Whole runs on the CPU at tiny sizes (the look for a card skipped): the
check holds the program correct, and comes out not correct when the timed
path is broken underneath it, and when a control stands in its place."""

import copy
import json

import pytest

from benchmark import run as bench_run
from benchmark.system import judge, run
from benchmark.tests.test_bench_spec import CELLS


def _run(cell, capsys):
    rc = bench_run.main(["--workload", cell.name, "--seed", str(2**31 + 11), "--seconds", "0.3", "--trace", "0"],
                        device="cpu", cell=cell)
    assert rc == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and err.strip().splitlines()[-1].startswith("check ")
    return result


def _unchanged(monkeypatch, cell):
    """A step that returns its state unchanged: K7 writes nothing (a solve's
    x stays 0), the apply returns its input (a chain's state never moves)."""
    from deal_and_ceed_on_gpu_torch.models.operator_base import MatrixFreeOperator
    from deal_and_ceed_on_gpu_torch.solvers import cg_merged

    if cell.traffic["kind"] == "cg":
        monkeypatch.setattr(cg_merged, "merged_update", lambda *a, **k: None)
    else:
        monkeypatch.setattr(MatrixFreeOperator, "vmult", lambda self, src: src.clone())


def _half(monkeypatch, cell):
    """Half of the work left out: the apply's upper half of rows never written."""
    from deal_and_ceed_on_gpu_torch.models.operator_base import MatrixFreeOperator

    orig = MatrixFreeOperator.vmult

    def vmult(self, src):
        out = orig(self, src)
        out[out.numel() // 2:] = 0
        return out

    monkeypatch.setattr(MatrixFreeOperator, "vmult", vmult)


def _altered(monkeypatch, cell):
    """An answer altered where it is produced: one entry of a solve's x, or
    of each apply's result, moved by the vector's largest magnitude."""
    from deal_and_ceed_on_gpu_torch.models.operator_base import MatrixFreeOperator
    from deal_and_ceed_on_gpu_torch.solvers import cg_merged

    def alter(v):
        v = v.clone()
        v.view(-1)[v.numel() // 2 + 3] += v.abs().max()
        return v

    if cell.traffic["kind"] == "cg":
        orig = cg_merged.solve_cg_merged

        def solve(*a, **k):
            x, info = orig(*a, **k)
            return alter(x), info

        monkeypatch.setattr(cg_merged, "solve_cg_merged", solve)
    else:
        orig = MatrixFreeOperator.vmult
        monkeypatch.setattr(MatrixFreeOperator, "vmult", lambda self, src: alter(orig(self, src)))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny_cell, capsys):
    result = _run(tiny_cell(name), capsys)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, tiny_cell, capsys, monkeypatch):
    cell = tiny_cell(name)
    fault(monkeypatch, cell)
    assert not _run(cell, capsys)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tiny_cell):
    # each of the traffic's controls in the program's place: the program's own
    # path one precision down, or the reference at a lower precision
    cell = tiny_cell(name)
    seed = 2**31 + 12
    _, samples, inputs, _ = run(cell, seed, 0.0, False, "cpu", 0.0)
    assert judge(cell, cell.kind.numbers(cell, samples, inputs, "cpu"))[1]
    for control in cell.traffic["controls"]:
        if control.startswith("program:"):
            low = copy.copy(cell)
            dtype = control.split(":", 1)[1]
            low.traffic = {**cell.traffic, "vectors": dtype, "compute": dtype, "dot_dtype": None}
            ctl = run(low, seed, 0.0, False, "cpu", 0.0)[1]
        else:
            units = cell.kind.reference_units(cell, inputs, [j for j, _, _ in samples], "cpu", control)
            ctl = [(j, out, work) for j, (out, work) in units.items()]
        assert not judge(cell, cell.kind.numbers(cell, ctl, inputs, "cpu"))[1], control
