"""K1 and K5 alone on the card at the shapes their main paths give them, beside their plain versions and a library call.

``k1_shapes`` builds K1's tables and input at each of its shapes and
``time_k1`` times one ``stencil_apply``, one ``stencil_apply_reference`` and,
where there is one, the library call that computes the element-local part
of the same operator; ``k5_shapes`` and ``time_k5`` do the same for one K5
iteration with its finishing pass (``CGFusedStep.iterate``) and the plain
``cg_step_reference`` + ``cg_next_scalars``. CUDA events, after a warm-up.
``chip_smoke.py`` phases 2, 12, 13 and 19 use them. The shapes:

- ``bp5``: BP5 at cycle 33 (``BrickMesh.bp5_cycle(33)``: 96 x 32 x 32
  elements, p = 5, GLL, grid 161 x 161 x 481), beside
  ``torch.matmul(U, A_loc)`` (U the gathered element vectors [98304, 216],
  A_loc the 216 x 216 element stiffness matrix);
- ``bp5-c40``: BP5 at cycle 40, the benchmark's size (128 x 128 x 64
  elements, grid 641 x 641 x 321), beside the same ``torch.matmul``;
- ``bp5-value``: the cycle-33 shape with the value term (the step-64 coefficient at
  the GLL nodes, collocated Helmholtz); no one library call computes it
  (the element matrix changes from element to element);
- ``bp6``: BP6's 3-component stack at 32^3 elements, p = 5 (``drivers/bp.py``
  at ``target_dofs = 4_000_000``: 3 x 161^3 points), beside the same
  ``torch.matmul`` on the three components' element vectors;

each in f64, f32 and bf16 storage (f32 compute); K5 runs ``bp5`` and
``bp5-value``. The library calls run in f64 and f32 only: none has bf16
storage with f32 compute.

Run: ``python -m deal_and_ceed_on_gpu_torch.scripts.bench_k1_k5``. It needs a
CUDA card. It uses only what the first ports of K1 and K5 already had, so a
copy of it in an older checkout times that checkout's kernels (in turns
with this one).
"""

from __future__ import annotations

import numpy as np
import torch

from ..basis import Basis1D
from ..drivers.bp import target_mesh
from ..mesh import BrickMesh
from ..ops.cg import CGFusedStep, cg_next_scalars, cg_step_reference
from ..ops.local_global import gather_elements
from ..ops.stencil import StencilTables, stencil_apply, stencil_apply_reference
from ..utils.timer import cuda_time_ms

__all__ = ["APPLIES", "BENCH_CYCLE", "DEGREE", "K1_SHAPES", "K5_SHAPES", "PRECISIONS", "helmholtz_nodal", "k1_shapes",
           "k5_shapes", "time_k1", "time_k5"]

DEGREE = 5
MAIN_CYCLE = 33
BENCH_CYCLE = 40
BP6_TARGET_DOFS = 4_000_000
# calls a timing averages (at ~0.05-0.4 ms a call)
APPLIES = 100
K1_SHAPES = ("bp5", "bp5-c40", "bp5-value", "bp6")
K5_SHAPES = ("bp5", "bp5-value")
# label: (storage, compute)
PRECISIONS = {"f64": (torch.float64, torch.float64), "f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.float32)}


def helmholtz_nodal(mesh: BrickMesh, p: int) -> np.ndarray:
    """The step-64 coefficient at the GLL nodes times the cell volume, as
    ``HelmholtzOperator(backend="stencil")`` builds its value table."""
    from ..fe_space import FESpace
    from ..models import default_coefficient

    space = FESpace(mesh, Basis1D.make(p), device="cpu")
    hx, hy, hz = mesh.h
    return default_coefficient(space.node_coords().reshape(space.grid_shape + (3,))) * (hx * hy * hz)


def _mesh(name: str) -> BrickMesh:
    if name == "bp6":
        return target_mesh(DEGREE, BP6_TARGET_DOFS)
    return BrickMesh.bp5_cycle(BENCH_CYCLE if name == "bp5-c40" else MAIN_CYCLE)


def _library(mesh: BrickMesh, basis: Basis1D, dtype: torch.dtype, device):
    """``U -> torch.matmul(U, A_loc)``: the element stiffness matrix of the
    uniform brick (GLL, p = 5: 216 x 216) applied to element vectors."""
    w, S, D = basis.q_weights, basis.S, basis.D
    B = np.einsum("q,qa,qb->ab", w, S, S)
    K = np.einsum("q,qa,qb->ab", w, D, D)
    hx, hy, hz = mesh.h
    loc = (hz * hy / hx * np.kron(B, np.kron(B, K)) + hz * hx / hy * np.kron(B, np.kron(K, B))
           + hy * hx / hz * np.kron(K, np.kron(B, B)))
    loc = torch.as_tensor(loc, dtype=dtype, device=device)
    return lambda U: torch.matmul(U, loc)


def _input(shape, label: str, device, seed: int) -> torch.Tensor:
    storage, compute = PRECISIONS[label]
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape), dtype=compute, device=device).to(storage)


def k1_shapes(names=K1_SHAPES, labels=tuple(PRECISIONS), device="cuda"):
    """Yield ``(shape, label, tables, u, library)`` for each shape and
    precision: K1's tables as the BP operators build them, a seeded input
    (``[3, nz, ny, nx]`` for bp6) and, for bp5 and bp6 in f64 and f32, the
    function ``U -> torch.matmul(U, A_loc)`` on element vectors (None
    elsewhere)."""
    basis = Basis1D.make(DEGREE)
    for name in names:
        if name not in K1_SHAPES:
            raise ValueError(f"unknown K1 shape {name!r}; known: {', '.join(K1_SHAPES)}")
        mesh = _mesh(name)
        value = helmholtz_nodal(mesh, DEGREE) if name == "bp5-value" else None
        for label in labels:
            compute = PRECISIONS[label][1]
            tables = StencilTables.create(mesh, basis, compute, device, value=value)
            shape = (3, *tables.shape) if name == "bp6" else tables.shape
            u = _input(shape, label, device, seed=7)
            library = None if label == "bf16" or value is not None else _library(mesh, basis, compute, device)
            yield name, label, tables, u, library


def time_k1(u: torch.Tensor, tables: StencilTables, library=None) -> tuple[float, float, float | None]:
    """ms of K1, of its plain version and of ``library`` (or None) on ``u``
    (the library on the element vectors of every component, gathered once,
    untimed). K1 and the library call are averaged over ``APPLIES`` calls
    after a warm-up."""
    ms = cuda_time_ms(lambda: stencil_apply(u, tables), n=APPLIES)
    plain_ms = cuda_time_ms(lambda: stencil_apply_reference(u, tables), n=3)
    if library is None:
        return ms, plain_ms, None
    p = tables.p
    n_el = tuple((n - 1) // p for n in tables.shape[::-1])
    U = torch.cat([gather_elements(c, n_el, p) for c in u.reshape(-1, *tables.shape)])
    return ms, plain_ms, cuda_time_ms(lambda: library(U), n=APPLIES)


def k5_shapes(names=K5_SHAPES, labels=tuple(PRECISIONS), device="cuda"):
    """Yield ``(shape, label, step, s, scal)`` for each shape and precision:
    K5 on the BP5 tables (with the value table for bp5-value), a seeded
    state ``[4, nz, ny, nx]`` and mid-solve scalars."""
    basis = Basis1D.make(DEGREE)
    for name in names:
        if name not in K5_SHAPES:
            raise ValueError(f"unknown K5 shape {name!r}; known: {', '.join(K5_SHAPES)}")
        mesh = _mesh(name)
        value = helmholtz_nodal(mesh, DEGREE) if name == "bp5-value" else None
        for label in labels:
            compute = PRECISIONS[label][1]
            tables = StencilTables.create(mesh, basis, compute, device, value=value)
            s = _input((4, *tables.shape), label, device, seed=5)
            scal = torch.tensor([0.7, 0.4, 0.7 / 0.4], dtype=compute, device=device)
            yield name, label, CGFusedStep(tables), s, scal


def time_k5(step: CGFusedStep, s: torch.Tensor, scal: torch.Tensor) -> tuple[float, float]:
    """ms of one K5 iteration with its finishing pass, as the solver calls
    them (into a second state buffer), and of the plain versions."""
    sw = torch.empty_like(s)
    ms = cuda_time_ms(lambda: step.iterate(s, sw, scal), n=APPLIES)
    plain_ms = cuda_time_ms(lambda: cg_next_scalars(cg_step_reference(s, scal, step.tables)[1]), n=3)
    return ms, plain_ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_k1_k5: needs a CUDA card")
    print(f"device {torch.cuda.get_device_name(0)}")
    for name, label, tables, u, library in k1_shapes():
        ms, plain_ms, library_ms = time_k1(u, tables, library)
        line = f"k1 {name} {label} shape {tuple(u.shape)}: K1 {ms:.4f} ms, plain {plain_ms:.4f} ms"
        if library_ms is not None:
            line += f", torch.matmul(U, A_loc) {library_ms:.4f} ms"
        print(line, flush=True)
        del u, tables
    for name, label, step, s, scal in k5_shapes():
        ms, plain_ms = time_k5(step, s, scal)
        print(f"k5 {name} {label} shape {tuple(s.shape)}: K5 + finish {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        del step, s


if __name__ == "__main__":
    main()
