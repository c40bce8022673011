"""The look for a card, and a short traced run where there is one."""

import json

import pytest
import torch

from benchmark import run as bench_run


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "bp5_c40_f32_vmult", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "needs 1 CUDA card" in err


def test_too_few_cards_no_result(monkeypatch, capsys, tiny_cell):
    cell = tiny_cell("bp5_c40_f32_vmult")
    cell.entry = {**cell.entry, "chips": 4}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = bench_run.main(["--workload", cell.name, "--seed", "1", "--seconds", "1", "--trace", "0"], cell=cell)
    out, _ = capsys.readouterr()
    assert rc == 2 and out == ""


@pytest.mark.cuda
def test_traced_run_on_the_card(card, tiny_cell, capsys):
    cell = tiny_cell("bp5_c40_f32_vmult")
    rc = bench_run.main(["--workload", cell.name, "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "1"],
                        device=card, cell=cell)
    out, _ = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"]
    assert result["device"]["platform"] == "gpu" and 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert "apply_roofline.vmult" in result["metrics"]
    assert 0 < result["metrics"]["apply_roofline.vmult"]["value"] <= 105
