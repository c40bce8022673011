"""One run of one cell: the inputs from the seed, the program's set-up and
warm-up, the measured window, the traced stretch and the check.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``: the mesh and its geometry, the element, the
operator, its coefficient and the program's backend for it, the solver's
control and preconditioner), a traffic mix (``workloads/<traffic>.json``:
its ``kind``, the vectors' precision, the check's sample, the controls) and
its limits (``limits/<cell>.json``). The traffic's kind, the configuration's
geometry and its preconditioner are modules of their own, found by name
(``kinds/<kind>.py``, ``geometries/<geometry>.py``,
``preconditioners/<preconditioner>.py``). A kind makes the inputs, drives
one unit of work through the program (a whole solve, a whole chain of
applies), and works out the numbers the check compares with the plain
reference. A geometry gives the program its mesh and the reference its
operator; a preconditioner gives each side its diagonal.

Every cell is a closed loop with one caller: whole units back to back,
each fenced by a synchronisation, as an HPC user runs them. Unit i takes
input ``i mod POOL``.

The program (``deal_and_ceed_on_gpu_torch``) is imported only inside the
functions that build and drive it. The inputs (right-hand sides, start
vectors, the chain's scale, the coefficient) are made by the benchmark and
handed to the program and, after the window, to the reference alike.
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import math
import os
import random
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import roofline
from .reference.brick import COEFFICIENTS, seed_int
from .trace import Stretch

__all__ = ["DTYPES", "PARTS", "POOL", "TRACE_AT", "TRACE_UNITS", "Cell", "RunData", "Unit", "build_program",
           "geometry", "inf_gap", "judge", "kernel_ctx", "kind", "load_cell", "metric_reader", "preconditioner",
           "reference_operator", "run", "seeded_normal", "sync"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}

POOL = 4  # distinct inputs a run cycles through
TRACE_AT = 0.4  # the traced stretch starts with the first unit past this share of the window
TRACE_UNITS = 2  # whole units the stretch records, after the profiler's warm-up on one apply

# the folders that hold a cell's parts, a module a name: what a part is -> its folder
PARTS = {"traffic kind": HERE / "kinds", "geometry": HERE / "geometries", "preconditioner": HERE / "preconditioners"}


@functools.cache
def _part(folder: Path, name: str, what: str):
    path = folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {what} {name!r} (no {os.path.relpath(path, ROOT)})")
    spec = importlib.util.spec_from_file_location(f"benchmark_{what.replace(' ', '_')}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """The module ``kinds/<name>.py`` of a traffic kind."""
    return _part(PARTS["traffic kind"], name, "traffic kind")


def geometry(name: str):
    """The module ``geometries/<name>.py`` of a configuration's geometry:
    ``program_mesh(cfg)``, ``reference_operator(cfg, dtype, device, scale)``,
    ``n_dofs(cfg)``, ``small(cfg, n_elements)``."""
    return _part(PARTS["geometry"], name, "geometry")


def preconditioner(name: str):
    """The module ``preconditioners/<name>.py`` of a configuration's
    preconditioner: ``DIAGONAL`` (whether it gives a vector),
    ``program(op)``, ``reference(ref_op, dtype)``."""
    return _part(PARTS["preconditioner"], name, "preconditioner")


def reference_operator(cfg: dict, dtype=torch.float64, device="cpu", scale: float = 1.0):
    """The plain reference's operator of a configuration, from its geometry."""
    return geometry(cfg["geometry"]).reference_operator(cfg, dtype, device, scale)


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    spec: dict

    @property
    def kind(self):
        return kind(self.traffic["kind"])

    @property
    def labels(self) -> list[str]:
        """The kernel labels (``kernels/<label>.py``) of this cell's path."""
        return [self.config["apply_kernel"], *self.kind.SOLVER_KERNELS]

    def metrics(self, section: str) -> list[dict]:
        """The metrics of ``section`` ("end_to_end" or "per_layer") this cell
        reports: those that list it, or that list no cells and (per layer)
        move an end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self._applicable("end_to_end")}
        out = []
        for m in self.spec[section]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def _applicable(self, section):
        return [m for m in self.spec[section] if "workloads" not in m or self.name in m["workloads"]]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and limits files."""
    spec = _read_json(spec_path)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    traffic = _read_json(HERE / "workloads" / f"{entry['traffic']}.json")
    limits = _read_json(HERE / "limits" / f"{name}.json")
    return Cell(name, entry, _read_json(ROOT / conf["file"]), traffic, limits, spec)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``; for a quantity split by the
    end-to-end metric it moves (``<base>.<suffix>``) with no file of its
    own, ``metrics/<base>.py``'s."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ program
def build_program(cell: Cell, scale: float, device):
    """The system under test through its public API: the geometry's mesh,
    the space, the operator with the configuration's coefficient on its
    backend (``op.vmult``), scaled by ``scale``. Refuses a geometry or
    coefficient it is not given here."""
    from deal_and_ceed_on_gpu_torch import models
    from deal_and_ceed_on_gpu_torch.fe_space import FESpace

    cfg, t = cell.config, cell.traffic
    mesh = geometry(cfg["geometry"]).program_mesh(cfg)
    space = FESpace.create(mesh, cfg["degree"], n_q=cfg["n_q"], rule=cfg["rule"], dtype=DTYPES[t["compute"]],
                           device=device)
    kw = {"backend": cfg["backend"]}
    if t["vectors"] != t["compute"]:
        kw["stream_dtype"] = DTYPES[t["vectors"]]
    coef = cfg.get("coefficient")
    if coef is not None:
        if cfg["operator"] != "HelmholtzOperator":
            raise ValueError(f"a coefficient needs the HelmholtzOperator, not {cfg['operator']!r}")
        a = COEFFICIENTS[coef]
        kw["coefficient_fn"] = lambda x: a(x[..., 0], x[..., 1], x[..., 2])
    op = getattr(models, cfg["operator"])(space, **kw)
    if scale != 1.0:
        op.fold_scale(scale)
    return op


class _Timed:
    """The benchmark's span around each call of the callable it hands the
    solver: host nanoseconds, no fence."""

    def __init__(self, fn):
        self.fn, self.ns, self.calls = fn, 0, 0

    def __call__(self, v):
        t0 = time.perf_counter_ns()
        out = self.fn(v)
        self.ns += time.perf_counter_ns() - t0
        self.calls += 1
        return out


class _Named:
    """The callable under ``record_function("apply")`` in the traced stretch."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, v):
        with torch.profiler.record_function("apply"):
            return self.fn(v)


class _Reservoir:
    """A uniform sample of ``k`` of the window's units, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed_int(seed, 2**32 + 7)), []

    def offer(self, i: int, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            r = self.rng.randrange(i + 1)
            if r < self.k:
                self.items[r] = item


@dataclass
class Unit:
    seconds: float
    work: int  # iterations of a solve, applies of a chain
    # "clean": no profiler has run yet in the process; "profiled": inside the
    # traced stretch; "after": past it (the profiler leaves the host slower)
    phase: str = "clean"


@dataclass
class RunData:
    """What the metric readers take."""

    cell: Cell
    ctx: dict
    setup_s: float
    units: list = field(default_factory=list)
    window_s: float = 0.0
    apply_ns: int = 0
    apply_calls: int = 0
    stretch: dict | None = None
    stretch_units: int = 0
    failed: int = 0
    setup_parts: dict = field(default_factory=dict)

    @property
    def kind(self) -> str:
        return self.cell.traffic["kind"]

    def unit_bound_s(self, work: int) -> float:
        """The least device seconds of one unit of ``work``: the apply's
        launches and, for a solve, K7's and K8's (one more of each a solve)."""
        b = roofline.kernel(self.cell.config["apply_kernel"]).bound_s(self.ctx, work, 1)
        for label in self.cell.kind.SOLVER_KERNELS:
            b += roofline.kernel(label).bound_s(self.ctx, work + 1, 1)
        return b


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def kernel_ctx(cell: Cell) -> dict:
    """What ``kernels/<label>.py`` counts a cell's work from: the DoFs ``n``
    (the geometry's), the element, the geometry's and the preconditioner's
    names, the bytes of a vector, of a coefficient and of the diagonal (0
    where the preconditioner gives none; the program's diagonal is at the
    compute type, ``kinds/cg.make_unit``)."""
    cfg, t = cell.config, cell.traffic
    coef_bytes = DTYPES[t["compute"]].itemsize
    return {"n": geometry(cfg["geometry"]).n_dofs(cfg), "degree": cfg["degree"], "n_q": cfg["n_q"],
            "n_elements": tuple(cfg["mesh"]["n_elements"]), "value_table": cfg.get("coefficient") is not None,
            "geometry": cfg["geometry"], "preconditioner": cfg["preconditioner"],
            "vector_bytes": DTYPES[t["vectors"]].itemsize, "coef_bytes": coef_bytes,
            "diag_bytes": coef_bytes if preconditioner(cfg["preconditioner"]).DIAGONAL else 0,
            "compute": t["compute"]}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_origin: float):
    """One run. ``t_origin``: the ``perf_counter`` reading that stands for the
    process's start. Returns ``(RunData, samples, inputs, memory_peak_bytes)``:
    ``samples`` is the seeded sample of the window's units that the check
    compares, ``[(input index, output, work)]``. The window holds one unit
    at least; with ``trace`` it goes on past ``seconds`` until the traced
    stretch has its units."""
    device = torch.device(device)
    k = cell.kind
    t_in = time.perf_counter()
    inputs = k.make_inputs(cell, seed, device)
    t_prog = time.perf_counter()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    op = build_program(cell, inputs["scale"], device)
    unit, warm = k.make_unit(cell, op, inputs, device)
    vm = op.vmult
    t_warm = time.perf_counter()
    warm(vm)
    sync(device)
    # the objects of the imports and the set-up leave the collector's scans:
    # its pauses inside the window then depend on the loop alone
    gc.collect()
    gc.freeze()
    data = RunData(cell, kernel_ctx(cell), 0.0)
    timed = _Timed(vm)
    reservoir = _Reservoir(cell.traffic["check_samples"], seed)
    stretch = None
    failed = 0
    t_start = time.perf_counter()
    data.setup_s = t_start - t_origin
    data.setup_parts = {"start_and_imports": t_in - t_origin, "inputs": t_prog - t_in, "program": t_warm - t_prog,
                        "warmup": t_start - t_warm}
    i, traced = 0, 0
    while (elapsed := time.perf_counter() - t_start) < seconds or i == 0 or (trace and traced < TRACE_UNITS):
        j = i % POOL
        if trace and stretch is None and elapsed >= TRACE_AT * seconds:
            stretch = Stretch(device, cell.labels)
            stretch.start(lambda: vm(inputs["pool"][0]))
        phase = "clean" if stretch is None else "profiled" if traced < TRACE_UNITS else "after"
        A = {"clean": timed if trace else vm, "profiled": _Named(vm), "after": vm}[phase]
        t0 = time.perf_counter()
        out, work, ok = unit(A, j)
        data.units.append(Unit(time.perf_counter() - t0, work, phase))
        failed += not ok
        reservoir.offer(i, (j, out, work))
        if phase == "profiled":
            traced += 1
            if traced == TRACE_UNITS:
                stretch.stop()
        i += 1
    data.window_s = time.perf_counter() - t_start
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    data.apply_ns, data.apply_calls = timed.ns, timed.calls
    if stretch is not None:
        data.stretch = stretch.read()
        data.stretch_units = traced
    data.failed = failed
    samples = reservoir.items
    del op, vm, timed, stretch, unit, warm
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return data, samples, inputs, memory_peak


# -------------------------------------------------------------------- check
def inf_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """``|out - ref|_inf / |ref|_inf`` in float64 (inf where not finite)."""
    o = out.reshape(-1).to(torch.float64)
    r = ref.reshape(-1).to(torch.float64)
    gap = float((o - r).abs().max() / r.abs().max())
    return gap if math.isfinite(gap) else math.inf


def judge(cell: Cell, numbers: dict) -> tuple[dict, bool]:
    """Each number the cell's limits name beside its limit, and whether
    every one is finite and within its limit."""
    checks = {name: {"value": numbers[name], "limit": limit} for name, limit in cell.limits.items()}
    return checks, all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def seeded_normal(shape, seed: int, index: int, device) -> torch.Tensor:
    """A float64 normal tensor drawn on ``device`` from the run's seed and an index."""
    g = torch.Generator(device=device).manual_seed(seed_int(seed, index))
    return torch.randn(shape, generator=g, dtype=torch.float64, device=device)
