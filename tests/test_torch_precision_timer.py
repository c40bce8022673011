"""The port's f32 precision is scoped to its own products, and its Timer is a
context manager: importing the package leaves the caller's TF32 settings
as they were, ``full_f32`` sets full precision inside and restores them on
exit, the port's contractions run in full f32 whatever the caller chose,
and ``with Timer() as t:`` times the block (a card test repeats the f32
parity with TF32 turned on by the caller)."""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import PoissonOperator
from deal_and_ceed_on_gpu_torch.ops import general as gk
from deal_and_ceed_on_gpu_torch.ops import sum_factorization as sf
from deal_and_ceed_on_gpu_torch.utils.timer import Timer


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture
def caller_tf32():
    """The caller's settings: TF32 on for matmul and cuDNN, precision "high";
    restored after the test."""
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield _flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
    torch.set_float32_matmul_precision(saved[2])


@pytest.mark.parametrize("matmul_tf32,cudnn_tf32,precision", [(True, True, "high"), (True, False, "medium"),
                                                              (False, False, "highest")])
def test_import_leaves_the_callers_settings(matmul_tf32, cudnn_tf32, precision):
    code = (
        "import torch\n"
        f"torch.backends.cuda.matmul.allow_tf32 = {matmul_tf32}\n"
        f"torch.backends.cudnn.allow_tf32 = {cudnn_tf32}\n"
        f"torch.set_float32_matmul_precision({precision!r})\n"
        "import deal_and_ceed_on_gpu_torch, deal_and_ceed_on_gpu_torch.models, deal_and_ceed_on_gpu_torch.ops\n"
        "import deal_and_ceed_on_gpu_torch.drivers.bp5, deal_and_ceed_on_gpu_torch.drivers.step64\n"
        "print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,"
        " torch.get_float32_matmul_precision())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout.split()
    assert out == [str(matmul_tf32), str(cudnn_tf32), precision]


@pytest.mark.parametrize("raises", [False, True])
def test_full_f32_sets_and_restores(caller_tf32, raises):
    class Boom(Exception):
        pass

    try:
        with sf.full_f32():
            assert _flags() == (False, False, "highest")
            if raises:
                raise Boom
    except Boom:
        assert raises
    assert _flags() == caller_tf32


def test_port_products_run_in_full_f32(caller_tf32, monkeypatch):
    """Every tensordot of ``sweep`` and every matmul of the plain K4 runs
    with TF32 off, though the caller turned it on; the caller's settings
    hold again afterwards."""
    seen = []
    tensordot, matmul = torch.tensordot, torch.Tensor.__matmul__

    def spy_tensordot(*a, **kw):
        seen.append(_flags())
        return tensordot(*a, **kw)

    def spy_matmul(self, other):
        seen.append(_flags())
        return matmul(self, other)

    monkeypatch.setattr(torch, "tensordot", spy_tensordot)
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy_matmul)
    space = pt.FESpace.create(pt.BrickMesh((2, 2, 2)), 2, n_q=4, rule="gauss", dtype=torch.float32, device="cpu")
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(space.n_dofs), dtype=torch.float32)
    PoissonOperator(space, backend="structured").vmult(u)
    k = gk.GeneralCellKernel(pt.Basis1D.make(2, 4, "gauss"), 3, torch.float32, grad=("const", (1.0, 2.0, 3.0)),
                             val=("const", 1.5), device="cpu")
    gk.general_apply_reference(torch.ones(3, 27), k)
    assert len(seen) > 10
    assert set(seen) == {(False, False, "highest")}
    assert _flags() == caller_tf32


def test_timer_as_context_manager():
    with Timer() as t:
        time.sleep(0.002)
    assert t.elapsed >= 0.002
    first = t.elapsed
    with t:  # accumulates, as start/stop do
        pass
    assert t.elapsed >= first


def test_timer_context_does_not_swallow_exceptions():
    t = Timer()
    with pytest.raises(ValueError):
        with t:
            raise ValueError("inside")
    assert t.elapsed > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_f32_parity_with_tf32_on_after_import_on_card(cuda_device, caller_tf32):
    """TF32 turned on after import: the structured Poisson apply in f32
    still agrees with f64, and K4 with its plain version, to 1e-5."""
    mesh = pt.BrickMesh((6, 5, 4)).deform(*pt.sine_map(0.05))
    rng = np.random.default_rng(5)
    out = {}
    for dtype in (torch.float64, torch.float32):
        space = pt.FESpace.create(mesh, 3, n_q=5, rule="gauss", dtype=dtype, device=cuda_device)
        if not out:
            u = torch.as_tensor(rng.standard_normal(space.n_dofs), device=cuda_device)
        out[dtype] = PoissonOperator(space, backend="structured").vmult(u.to(dtype)).double()
    want = out[torch.float64]
    assert float((out[torch.float32] - want).abs().max() / want.abs().max()) <= 1e-5
    basis = pt.Basis1D.make(4, 6, "gauss")
    c = 0.2 * rng.random((50, 216, 6))
    c[..., (0, 3, 5)] += 1.0
    k = gk.GeneralCellKernel(basis, 50, torch.float32, grad=("full6", c), val=("table", 0.5 + rng.random((50, 216))),
                             device=cuda_device)
    u = torch.as_tensor(rng.standard_normal((50, 125)), dtype=torch.float32, device=cuda_device)
    got = gk.general_apply(u, k, out=torch.full_like(u, float("nan")))
    want = gk.general_apply_reference(u, k)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert _flags() == caller_tf32
