"""K2 alone on the card at the shapes its main path gives it, beside its plain version, a library call and K4.

``k2_shapes`` builds K2's tables at each shape; ``time_k2`` times one
``banded_apply``, one ``banded_apply_reference`` and, where there is one,
the library call that computes the element-local part of the same operator
(CUDA events, after a warm-up). ``chip_smoke.py`` phase 18 uses both. The
shapes are those of ``drivers/bp.py`` at p = 5, ``target_dofs =
4_000_000``: 32^3 elements, Gauss q = 7, 4,173,281 points a component:

- ``bp1``: mass, beside ``torch.matmul(U, M_loc)`` (U the gathered element
  vectors [E, 216], M_loc the 216 x 216 element mass matrix);
- ``bp2``: mass, 3 components in one launch;
- ``bp3``: stiffness, beside ``torch.matmul(U, A_loc)`` (the element
  stiffness matrix) and K4 (``general``, const grad) on the same mesh;
- ``bp4``: stiffness, 3 components;
- ``bp3-graded``: stiffness on a graded brick of 32^3 elements;

each in f64, f32 and bf16 storage (f32 compute). The library calls and K4
run in f64 and f32 only: neither has bf16 storage with f32 compute.

Run: ``python -m deal_and_ceed_on_gpu_torch.scripts.bench_k2``. It needs a
CUDA card. It uses only what K2's first port already had, so a copy of it
in an older checkout times that checkout's K2 (in turns with this one).
"""

from __future__ import annotations

import numpy as np
import torch

from ..basis import Basis1D
from ..drivers.bp import target_mesh
from ..mesh import BrickMesh
from ..ops.banded import BandedTables, banded_apply, banded_apply_reference
from ..ops.local_global import gather_elements
from ..utils.timer import cuda_time_ms

__all__ = ["APPLIES", "DEGREE", "PRECISIONS", "SHAPES", "k2_input", "k2_shapes", "k4_ms", "time_k2"]

DEGREE = 5
TARGET_DOFS = 4_000_000
# calls a timing averages: at ~0.06 ms a call, 20 read 2-4 % higher (the
# clock's ramp after the warm-up shows in the mean)
APPLIES = 100
SHAPES = ("bp1", "bp2", "bp3", "bp4", "bp3-graded")
# label: (storage, compute)
PRECISIONS = {"f64": (torch.float64, torch.float64), "f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.float32)}
_KIND = {"bp1": ("mass", 1), "bp2": ("mass", 3), "bp3": ("stiffness", 1), "bp4": ("stiffness", 3),
         "bp3-graded": ("stiffness", 1)}


def _mesh(name: str) -> BrickMesh:
    mesh = target_mesh(DEGREE, TARGET_DOFS)
    if name != "bp3-graded":
        return mesh
    rng = np.random.default_rng(7)
    return BrickMesh.graded(*(np.cumsum(np.concatenate([[0.0], 0.6 + rng.random(m)])) for m in mesh.n_elements))


def _library(name: str, mesh: BrickMesh, basis: Basis1D, dtype: torch.dtype, device):
    """``u -> torch.matmul(U, M_loc or A_loc)`` on the gathered element
    vectors of ``u`` (its argument), for bp1 and bp3; else None."""
    if name not in ("bp1", "bp3"):
        return None
    w, S, D = basis.q_weights, basis.S, basis.D
    B = np.einsum("q,qa,qb->ab", w, S, S)
    K = np.einsum("q,qa,qb->ab", w, D, D)
    hx, hy, hz = (float(h[0]) for h in mesh.h_axes())
    if name == "bp1":
        loc = hz * hy * hx * np.kron(B, np.kron(B, B))
    else:
        loc = (hz * hy / hx * np.kron(B, np.kron(B, K)) + hz * hx / hy * np.kron(B, np.kron(K, B))
               + hy * hx / hz * np.kron(K, np.kron(B, B)))
    loc = torch.as_tensor(loc, dtype=dtype, device=device)
    return lambda U: torch.matmul(U, loc)


def k2_shapes(names=SHAPES, labels=tuple(PRECISIONS), device="cuda"):
    """Yield ``(shape, label, tables, nc, library)`` for each shape and
    precision: K2's tables as the BP operators build them, the component
    count, and (bp1, bp3 in f64 and f32) the function ``U -> torch.matmul(U,
    M_loc or A_loc)`` on element vectors ``U`` (None elsewhere)."""
    basis = Basis1D.make(DEGREE, DEGREE + 2, "gauss")
    for name in names:
        if name not in _KIND:
            raise ValueError(f"unknown shape {name!r}; known: {', '.join(SHAPES)}")
        kind, nc = _KIND[name]
        mesh = _mesh(name)
        for label in labels:
            _, compute = PRECISIONS[label]
            tables = BandedTables.create(mesh, basis, compute, device, kind)
            library = None if label == "bf16" else _library(name, mesh, basis, compute, device)
            yield name, label, tables, nc, library


def k2_input(tables: BandedTables, label: str, nc: int, seed: int = 7) -> torch.Tensor:
    """A seeded input of the shape's grid (``[nc, nz, ny, nx]`` for nc > 1)
    at the precision's storage type."""
    shape = tables.shape if nc == 1 else (nc, *tables.shape)
    u = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(u, dtype=tables.dtype, device=tables.device).to(PRECISIONS[label][0])


def time_k2(u: torch.Tensor, tables: BandedTables, library=None) -> tuple[float, float, float | None]:
    """ms of K2, of its plain version and of ``library`` (or None) on ``u``
    (the library on ``u``'s element vectors, gathered once, untimed). K2 and
    the library call are averaged over ``APPLIES`` calls after a warm-up."""
    ms = cuda_time_ms(lambda: banded_apply(u, tables), n=APPLIES)
    plain_ms = cuda_time_ms(lambda: banded_apply_reference(u, tables), n=3)
    if library is None:
        return ms, plain_ms, None
    p = tables.p
    U = gather_elements(u, tuple((n - 1) // p for n in tables.shape[::-1]), p)
    return ms, plain_ms, cuda_time_ms(lambda: library(U), n=APPLIES)


def k4_ms(label: str, u: torch.Tensor, tables: BandedTables) -> float:
    """ms of K4 (const grad: BP3's operator element by element) on the
    element vectors of BP3's ``u`` (f64 or f32)."""
    from .bench_k4 import k4_shapes, time_k4

    for _, lab, k, _ in k4_shapes(["bp3-const"], device=u.device):
        if lab == label:
            U = gather_elements(u, tuple((n - 1) // tables.p for n in tables.shape[::-1]), tables.p)
            return time_k4(U, k)[0]
    raise ValueError(f"K4 has no {label} BP3 shape")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_k2: needs a CUDA card")
    print(f"device {torch.cuda.get_device_name(0)}")
    for name, label, tables, nc, library in k2_shapes():
        u = k2_input(tables, label, nc)
        ms, plain_ms, library_ms = time_k2(u, tables, library)
        line = f"k2 {name} {label} shape {tuple(u.shape)}: K2 {ms:.4f} ms, plain {plain_ms:.4f} ms"
        if library_ms is not None:
            line += f", torch.matmul(U, {'M' if name == 'bp1' else 'A'}_loc) {library_ms:.4f} ms"
        if name == "bp3" and label != "bf16":
            line += f", K4 {k4_ms(label, u, tables):.4f} ms"
        print(line, flush=True)
        del u


if __name__ == "__main__":
    main()
