"""What a run imports: never JAX, jaxlib, flax or the JAX package; the reference never the program."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    # a whole small run on the CPU, then the run's own look at sys.modules
    code = (
        "import sys, copy; sys.path.insert(0, '.')\n"
        "from benchmark.system import load_cell, run, metric_reader\n"
        "from benchmark.run import forbidden_modules\n"
        "import benchmark.calibrate\n"
        "c = load_cell('bp5_c40_f32_vmult'); c.config = copy.deepcopy(c.config)\n"
        "c.config['mesh']['n_elements'] = [2, 2, 2]\n"
        "d, s, i, _ = run(c, 5, 0.2, True, 'cpu', 0.0)\n"
        "c.kind.numbers(c, s, i, 'cpu')\n"
        "[metric_reader(m['name'])(d) for m in c.metrics('per_layer')]\n"
        "assert 'deal_and_ceed_on_gpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n"
    )
    assert _python(code) == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from benchmark.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)  # begins with "jax": not JAX
    monkeypatch.setitem(sys.modules, "deal_and_ceed_on_gpu_tpu_x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "deal_and_ceed_on_gpu_tpu.ops", sys)
    assert forbidden_modules() == ["deal_and_ceed_on_gpu_tpu"]


def test_reference_imports_nothing_of_the_program():
    allowed = {"math", "numpy", "torch", "__future__"}
    for path in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: the reference's own modules
                    continue
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, f"{path.name} imports {name}"
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference.brick, benchmark.reference.cg, benchmark.reference.precision\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'deal_and_ceed_on_gpu_torch', "
            "'deal_and_ceed_on_gpu_tpu', 'jax'}))")
    assert _python(code) == "[]"
