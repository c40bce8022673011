"""FESpace: the matrix-free data container (reference
``CUDAWrappers::MatrixFree`` L-1/L-5, ``bp5/step-64.cu:235-258``).

Bundles mesh + basis + geometry with a torch dtype and device, and holds the
Dirichlet (constrained-DoF) mask that replaces ``AffineConstraints``.
Global DoF vectors are flat ``[n_dofs]`` tensors ordered z slowest over the
``[nz, ny, nx]`` nodal grid (the same order as the JAX package);
``initialize_dof_vector`` mirrors ``MatrixFree::initialize_dof_vector``
(``bp5/step-64.cu:211-215``).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from .basis import Basis1D
from .geometry import Geometry
from .mesh import BrickMesh

__all__ = ["FESpace"]


@dataclasses.dataclass(frozen=True)
class FESpace:
    mesh: BrickMesh
    basis: Basis1D
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")

    @staticmethod
    def create(
        mesh: BrickMesh,
        degree: int,
        n_q: int | None = None,
        rule: str = "gauss_lobatto",
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ) -> "FESpace":
        return FESpace(mesh, Basis1D.make(degree, n_q, rule), dtype, torch.device(device))

    # ------------------------------------------------------------------ #
    @property
    def degree(self) -> int:
        return self.basis.degree

    @property
    def n_dofs(self) -> int:
        return self.mesh.n_dofs(self.degree)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        """(nz, ny, nx) nodal grid shape."""
        nx, ny, nz = self.mesh.n_nodes(self.degree)
        return (nz, ny, nx)

    @cached_property
    def geometry(self) -> Geometry:
        return Geometry.from_mesh(self.mesh, self.basis)

    def tensor(self, a) -> torch.Tensor:
        """Host array -> tensor in this space's dtype on its device."""
        return torch.as_tensor(np.array(a), dtype=self.dtype, device=self.device)

    @cached_property
    def S(self) -> torch.Tensor:
        return self.tensor(self.basis.S)

    @cached_property
    def D(self) -> torch.Tensor:
        return self.tensor(self.basis.D)

    # ------------------------------------------------------------------ #
    @cached_property
    def dirichlet_mask(self) -> torch.Tensor:
        """bool ``[n_dofs]``; True on constrained (boundary) DoFs."""
        return torch.as_tensor(
            self.mesh.boundary_dof_mask(self.degree), device=self.device
        )

    @cached_property
    def elem_dof_map(self) -> torch.Tensor:
        """int32 ``[n_cells, (p+1)^3]`` local_to_global on the device (the
        ``gather`` backend; ``mesh.element_dof_map`` on the host)."""
        return torch.as_tensor(self.mesh.element_dof_map(self.degree), device=self.device)

    @cached_property
    def scatter_plan(self):
        """The deterministic scatter-add plan of :attr:`elem_dof_map`
        (``ops.local_global.make_scatter_plan``), built once."""
        from .ops.local_global import make_scatter_plan

        return make_scatter_plan(self.mesh.element_dof_map(self.degree), self.n_dofs, device=self.device)

    def initialize_dof_vector(self) -> torch.Tensor:
        return torch.zeros((self.n_dofs,), dtype=self.dtype, device=self.device)

    def node_coords(self) -> np.ndarray:
        """``[n_dofs, 3]`` physical coordinates of the global DoFs
        (x fastest), host-side; includes the mesh deformation if any."""
        cx, cy, cz = self.mesh.node_coords_1d(self.degree, self.basis.nodes)
        nz, ny, nx = self.grid_shape
        X = np.zeros((nz, ny, nx, 3))
        X[..., 0] = cx[None, None, :]
        X[..., 1] = cy[None, :, None]
        X[..., 2] = cz[:, None, None]
        return self.mesh.map_points(X).reshape(-1, 3)

    def copy_constrained_values(
        self, src: torch.Tensor, dst: torch.Tensor
    ) -> torch.Tensor:
        """Dirichlet rows act as identity (reference L-4,
        ``bp5/step-64.cu:275``)."""
        return torch.where(self.dirichlet_mask, src, dst)

    def zero_constrained_values(self, src: torch.Tensor) -> torch.Tensor:
        """Zero constrained entries (keeps the operator symmetric: the
        effective operator is identity on the constrained subspace plus the
        interior stiffness on its complement)."""
        return src.masked_fill(self.dirichlet_mask, 0)
