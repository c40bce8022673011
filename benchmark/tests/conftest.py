"""The benchmark's own tests, on the CPU (``python -m pytest benchmark/tests -q``
from the root of the checkout); tests marked ``cuda`` need a card and skip
without one. They import neither JAX nor the JAX package."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the cells at sizes a CPU test holds: their element counts (x, y, z)
TINY = {"bp5_c40_f64_cg": [12, 12, 6], "step64_r7_f64_cg": [4, 4, 4], "bp5_c40_bf16_cg": [24, 24, 12],
        "bp5_c40_f32_vmult": [4, 4, 2]}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the cell of ``BENCHMARK.json`` on a brick of
    ``TINY[name]`` elements over the same domain (the same element and
    control, so h is larger)."""
    from benchmark.system import load_cell

    def make(name):
        cell = load_cell(name)
        cell.config = copy.deepcopy(cell.config)
        cell.config["mesh"]["n_elements"] = TINY[name]
        return cell

    return make


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
