"""K4 alone on the card at the shapes its main paths give it, beside its plain version.

``k4_shapes`` builds K4's tables at each shape; ``time_k4`` times one
``general_apply``, one ``general_apply_reference`` and, where there is one,
the library call that computes the same function (CUDA events, after a
warm-up). ``chip_smoke.py`` phase 22 uses both. The shapes:

- ``mapped52-full6``: the sine-mapped 52^3 vmult (``scripts/bench_general``),
  p = 3, Gauss q = 4, the full6 table, f64 and f32;
- ``bp3-const``: BP3's shape (p = 5, Gauss q = 7, 32^3 brick), grad const,
  f64 and f32, beside ``torch.matmul(U, A_loc)`` with the 216 x 216 element
  matrix;
- ``mapped32-gll-full6``: the sine-mapped 32^3 solve's shape
  (``scripts/bench_solvers_r3``), p = 3, GLL, full6, f64;
- ``step64-r6``: step-64 at refine 6 on ``general`` (64^3 elements, Q3,
  Gauss q = 4, const grad + the a(x) JxW value table), f64.

Run: ``python -m deal_and_ceed_on_gpu_torch.scripts.bench_k4``. It needs a
CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..basis import Basis1D
from ..fe_space import FESpace
from ..mesh import BrickMesh, sine_map
from ..models.helmholtz import default_coefficient
from ..models.poisson import grad_spec
from ..ops.general import GeneralCellKernel, general_apply, general_apply_reference, general_tables_np
from ..utils.timer import cuda_time_ms

__all__ = ["SHAPES", "k4_shapes", "step64_kernel", "time_k4"]

SHAPES = ("mapped52-full6", "bp3-const", "mapped32-gll-full6", "step64-r6")
_DTYPES = {"f64": torch.float64, "f32": torch.float32}


def _mapped_full6(m: int, rule: str):
    space = FESpace.create(BrickMesh((m,) * 3).deform(*sine_map(0.05)), 3, n_q=4, rule=rule, dtype=torch.float64,
                           device="cpu")
    return general_tables_np(space.basis, space.mesh.n_cells, grad=("full6", space.geometry.merged_coef_full()))


def step64_kernel(refine: int, device="cuda") -> GeneralCellKernel:
    """K4's tables in step-64 on ``general`` (``HelmholtzOperator(space,
    backend="general")``: Q3, Gauss q = 4, const grad + the a(x) JxW value
    table) at ``refine``, f64."""
    space = FESpace.create(BrickMesh.hyper_cube().refine_global(refine), 3, rule="gauss", dtype=torch.float64,
                           device="cpu")
    geo = space.geometry
    a_q = np.asarray(default_coefficient(geo.q_points_phys()), dtype=np.float64)
    return GeneralCellKernel(space.basis, space.mesh.n_cells, torch.float64, grad=grad_spec(geo, weighted=True),
                             val=("table", a_q * geo.jxw_full()), w3d=geo.w3d, device=device)


def k4_shapes(names=SHAPES, device="cuda"):
    """Yield ``(shape, label, kernel, library)`` for each shape and precision:
    the K4 table set the main path builds, and (BP3 only) the function
    ``u -> torch.matmul(u, A_loc)`` that computes the same apply."""
    for name in names:
        if name == "mapped52-full6":
            tabs = _mapped_full6(52, "gauss")
            for label in ("f64", "f32"):
                yield name, label, GeneralCellKernel.from_numpy(tabs, _DTYPES[label], device), None
        elif name == "bp3-const":
            mesh = BrickMesh((32, 32, 32))
            geo = FESpace.create(mesh, 5, n_q=7, rule="gauss", device="cpu").geometry
            for label in ("f64", "f32"):
                k = GeneralCellKernel(Basis1D.make(5, 7, "gauss"), mesh.n_cells, _DTYPES[label],
                                      grad=("const", geo.const_merged_diag), w3d=geo.w3d, device=device)
                _, G = k.dense_tables
                a_loc = sum((G[d] * k.cw[d]) @ G[d].T for d in range(3))
                yield name, label, k, (lambda u, a_loc=a_loc: torch.matmul(u, a_loc))
        elif name == "mapped32-gll-full6":
            tabs = _mapped_full6(32, "gauss_lobatto")
            yield name, "f64", GeneralCellKernel.from_numpy(tabs, torch.float64, device), None
        elif name == "step64-r6":
            yield name, "f64", step64_kernel(6, device), None
        else:
            raise ValueError(f"unknown shape {name!r}; known: {', '.join(SHAPES)}")


def time_k4(u: torch.Tensor, k: GeneralCellKernel, library=None) -> tuple[float, float, float | None]:
    """ms of K4, of its plain version and of ``library`` (or None) on ``u``."""
    ms = cuda_time_ms(lambda: general_apply(u, k))
    plain_ms = cuda_time_ms(lambda: general_apply_reference(u, k), n=5)
    return ms, plain_ms, None if library is None else cuda_time_ms(lambda: library(u))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_k4: needs a CUDA card")
    print(f"device {torch.cuda.get_device_name(0)}")
    for name, label, k, library in k4_shapes():
        u = torch.as_tensor(np.random.default_rng(7).standard_normal((k.n_cells, k.n_local)), dtype=k.dtype,
                            device="cuda")
        ms, plain_ms, library_ms = time_k4(u, k, library)
        line = f"k4 {name} {label} E={k.n_cells}: K4 {ms:.4f} ms, plain {plain_ms:.4f} ms"
        if library_ms is not None:
            line += f", torch.matmul(U, A_loc) {library_ms:.4f} ms"
        print(line, flush=True)


if __name__ == "__main__":
    main()
