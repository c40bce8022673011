"""The port's auxiliary modules and driver outputs on the CPU: utils/profiling
(roofline and the card's peaks, a trace file), utils/host_memory (idempotent, its
opt-out), the utils exports against the JAX package's, bp5's
``--backend auto`` resolution (no solve), and step-64's ``--vtu`` at its
golden fingerprint."""

import json
import struct

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.drivers import bp5, step64
from deal_and_ceed_on_gpu_torch.utils import host_memory, profiling

STEP64_REFINE2 = (60, 0.020526851356887806)  # the JAX golden (chip_smoke.STEP64_GOLDEN[2])


def test_roofline_keys_and_card_peaks():
    roof = profiling.roofline(1_000_000, 5, dtype_bytes=8)
    assert set(roof) == {"bandwidth_bound_gdofs", "compute_bound_gdofs"}
    # one read and one write of 8 bytes a DoF at the card's 3.35 TB/s
    assert roof["bandwidth_bound_gdofs"] == pytest.approx(profiling.HBM_BYTES_PER_S / 16 / 1e9)
    assert roof["compute_bound_gdofs"] == pytest.approx(profiling.PEAK_FLOPS["f32"] / (6 * 11) / 1e9)
    # f64 outside the tensor cores, where the port's kernels compute
    assert profiling.PEAK_FLOPS == {"f64": 34e12, "f32": 67e12, "bf16": 67e12}
    assert not hasattr(profiling, "op_stats")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(tmp_path, "t") as prof:
        (a @ a).sum()
    assert prof.trace_path == tmp_path / "t.json"
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    readings = profiling.busy_profile("aux: matmul", 1, lambda: a @ a, repeats=2, logdir=tmp_path)
    assert len(readings) == 2 and all(w > 0 for w, _ in readings)


def test_tune_host_allocator_is_idempotent_and_honours_its_opt_out(monkeypatch):
    assert host_memory.OPT_OUT == "DCG_TORCH_MALLOPT"
    assert host_memory.tune_host_allocator() is host_memory.tune_host_allocator()
    monkeypatch.setattr(host_memory, "_done", False)
    monkeypatch.setenv(host_memory.OPT_OUT, "0")
    assert host_memory.tune_host_allocator() is False and host_memory._done is False
    monkeypatch.delenv(host_memory.OPT_OUT)
    first = host_memory.tune_host_allocator()
    assert host_memory.tune_host_allocator() is first  # glibc here: True both times
    assert first is host_memory._done


def test_utils_export_what_the_jax_packages_export():
    import deal_and_ceed_on_gpu_torch.utils as ut
    import deal_and_ceed_on_gpu_tpu.utils as ju

    jax_only = {"ensure_x64", "enable_compilation_cache", "jit_hoisted"}  # ROADMAP.md, "Not to port"
    assert set(ut.__all__) == set(ju.__all__) - jax_only
    for name in ut.__all__:
        assert getattr(ut, name) is not None
    assert ut.pcout0 is ut.rank0_print


@pytest.mark.parametrize("dtype,stream", [("float64", None), ("float32", None), ("float32", "bfloat16")])
def test_auto_backend_resolves_by_the_thresholds(dtype, stream):
    """A uniform GLL cycle goes to stencil at or above its precision's
    threshold and to separable below; a Gauss rule to general; the stream
    dtype counts with f32 compute only."""
    thresh = bp5.AUTO_THRESHOLDS[(dtype, stream)]
    cfg = bp5.BP5Config(dtype=dtype, stream_dtype=stream, backend="auto")
    for cycle in (3, 10, 33, 40):
        mesh = pt.BrickMesh.bp5_cycle(cycle)
        want = "stencil" if mesh.n_dofs(5) >= thresh else "separable"
        assert bp5.resolve_backend(cfg, mesh) == want
    gauss = bp5.BP5Config(dtype=dtype, stream_dtype=stream, backend="auto", rule="gauss")
    assert bp5.resolve_backend(gauss, pt.BrickMesh.bp5_cycle(10)) == "general"
    assert bp5.resolve_backend(bp5.BP5Config(backend="banded"), pt.BrickMesh.bp5_cycle(10)) == "banded"
    f64_bf16 = bp5.BP5Config(dtype="float64", stream_dtype="bfloat16", backend="auto")
    mesh = pt.BrickMesh.bp5_cycle(10)
    assert bp5.resolve_backend(f64_bf16, mesh) == bp5.resolve_backend(bp5.BP5Config(dtype="float64",
                                                                                    backend="auto"), mesh)


def test_step64_vtu_keeps_the_golden_fingerprint(tmp_path, capsys):
    """``--vtu`` writes the merged run's solution; refine 2 still takes the
    golden 60 iterations to the golden L2 norm, plain and merged."""
    path = tmp_path / "step64.vtr"
    step64.main(["--refine", "2", "--device", "cpu", "--vtu", str(path)])
    out = capsys.readouterr().out
    assert out.count("Solved in 60 iterations.") == 2 and f"wrote {path}" in out
    r = step64.run(2, use_merged=True, device="cpu")
    assert r["n_iterations"] == STEP64_REFINE2[0]
    assert abs(r["l2_norm"] - STEP64_REFINE2[1]) <= 1e-10 * STEP64_REFINE2[1]
    body = path.read_bytes().split(b'<AppendedData encoding="raw">\n_', 1)[1]
    (n,) = struct.unpack_from("<Q", body, 0)
    np.testing.assert_array_equal(np.frombuffer(body[8:8 + n]), r["x"].numpy())


def test_slice_h_imports_leave_jax_out_and_build_nothing():
    """The new modules import neither jax nor the JAX package, and importing
    them builds no native library (it is built at first use)."""
    import subprocess
    import sys

    code = (
        "import sys, deal_and_ceed_on_gpu_torch.utils as u, deal_and_ceed_on_gpu_torch.utils.vtk, "
        "deal_and_ceed_on_gpu_torch.utils.native as n, deal_and_ceed_on_gpu_torch.utils.profiling, "
        "deal_and_ceed_on_gpu_torch.utils.host_memory as h, deal_and_ceed_on_gpu_torch.scripts.sweep_auto, "
        "deal_and_ceed_on_gpu_torch.scripts.bench_general, deal_and_ceed_on_gpu_torch.drivers.amr; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', "
        "'deal_and_ceed_on_gpu_tpu')]; built = n.get_lib.cache_info().currsize; "
        "print(bad, built, h._done); sys.exit(1 if bad or built else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-1] == "True"  # the allocator tuned at the package's import
