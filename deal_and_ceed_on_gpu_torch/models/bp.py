"""CEED bake-off problem registry: BP1..BP6.

Counterpart of ``deal_and_ceed_on_gpu_tpu/models/bp.py``: the CEED BPs
(Fischer et al., "Scalability of high-performance PDE solvers", IJHPCA
2020) as configured in BASELINE.json:

| BP  | form      | components | quadrature            |
|-----|-----------|------------|-----------------------|
| BP1 | mass      | 1          | Gauss, q = p+2        |
| BP2 | mass      | 3          | Gauss, q = p+2        |
| BP3 | stiffness | 1          | Gauss, q = p+2        |
| BP4 | stiffness | 3          | Gauss, q = p+2        |
| BP5 | stiffness | 1          | GLL (colloc.), q = p+1|
| BP6 | stiffness | 3          | GLL (colloc.), q = p+1|

``make_bp_operator`` with ``backend=None`` takes the port's kernels: K1
(``stencil``) for the collocated stiffness of BP5/BP6 on a uniform brick,
K4 (``general``) on a mapped mesh, K2 (``banded``) for everything else;
``general`` and ``qgrid`` take any BP, and ``separable`` and ``structured``
stay selectable as the plain comparators.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fe_space import FESpace
from ..mesh import BrickMesh
from .mass import MassOperator
from .poisson import PoissonOperator
from .vector import VectorOperator

__all__ = ["BP_SPECS", "BPSpec", "default_backend", "make_bp_operator"]


@dataclasses.dataclass(frozen=True)
class BPSpec:
    kind: str  # "mass" | "stiffness"
    n_components: int
    rule: str  # "gauss" | "gauss_lobatto"
    n_q_offset: int  # n_q = p + 1 + offset


BP_SPECS = {
    "bp1": BPSpec("mass", 1, "gauss", 1),
    "bp2": BPSpec("mass", 3, "gauss", 1),
    "bp3": BPSpec("stiffness", 1, "gauss", 1),
    "bp4": BPSpec("stiffness", 3, "gauss", 1),
    "bp5": BPSpec("stiffness", 1, "gauss_lobatto", 0),
    "bp6": BPSpec("stiffness", 3, "gauss_lobatto", 0),
}


def default_backend(spec: BPSpec, mesh: BrickMesh) -> str:
    """The kernel backend of a BP: K1 needs GLL collocation and a uniform
    brick, K2 takes any rule on a uniform or graded brick, K4 any rule on
    any mesh."""
    if spec.kind == "stiffness" and spec.rule == "gauss_lobatto" and mesh.is_uniform:
        return "stencil"
    return "general" if mesh.is_mapped else "banded"


def make_bp_operator(
    bp: str,
    mesh: BrickMesh,
    degree: int,
    dtype: torch.dtype = torch.float32,
    backend: str | None = None,
    stream_dtype: torch.dtype | None = None,
    device="cuda",
):
    """Build ``(space, operator)`` for a named bake-off problem; the vector
    BPs get a :class:`VectorOperator` on ``[3, n]`` tensors.
    ``stream_dtype``: the dtype of the vectors the operator takes and
    returns (bfloat16 halves their bytes; the apply computes at ``dtype``)."""
    spec = BP_SPECS[bp.lower()]
    space = FESpace.create(
        mesh, degree, n_q=degree + 1 + spec.n_q_offset, rule=spec.rule, dtype=dtype, device=device
    )
    backend = backend or default_backend(spec, mesh)
    cls = MassOperator if spec.kind == "mass" else PoissonOperator
    op = cls(space, backend=backend, stream_dtype=stream_dtype)
    if spec.n_components > 1:
        return space, VectorOperator(op, spec.n_components)
    return space, op
