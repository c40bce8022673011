"""Element geometry on brick meshes: JxW and merged diffusion coefficients.

Host copy of the brick path of ``deal_and_ceed_on_gpu_tpu/geometry.py``
(the reference's ``JacobianFunctor`` coefficient precompute,
``bp5/step-64.cu:60-114``): on an axis-aligned brick the Jacobian is
diagonal, so the merged coefficient ``C(q) = JxW(q) * J^{-1} J^{-T}`` is
``det(J) * w3d(q) * diag(1/h^2)`` — on a uniform brick three scalars, on a
graded one a per-element diagonal (``merged_diag_per_cell``). Mapped meshes
and the six-plane ``merged_coef_full`` table are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .basis import Basis1D
from .mesh import BrickMesh

__all__ = ["Geometry"]


def _tensor_weights(basis: Basis1D) -> np.ndarray:
    w = basis.q_weights
    return w[:, None, None] * w[None, :, None] * w[None, None, :]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Metric terms for a brick mesh + quadrature rule; ``uniform`` selects
    the constant fast path (scalar ``h``/``det_j``/``const_merged_diag``)."""

    mesh: BrickMesh
    basis: Basis1D
    w3d: np.ndarray  # [qz, qy, qx]

    @staticmethod
    def from_mesh(mesh: BrickMesh, basis: Basis1D) -> "Geometry":
        w3d = _tensor_weights(basis)
        w3d.setflags(write=False)
        return Geometry(mesh, basis, w3d)

    @property
    def uniform(self) -> bool:
        return self.mesh.is_uniform

    @property
    def n_q(self) -> int:
        return self.basis.n_q ** 3

    @property
    def h(self) -> tuple[float, float, float]:
        return self.mesh.h

    @property
    def det_j(self) -> float:
        hx, hy, hz = self.mesh.h
        return hx * hy * hz

    @property
    def inv_h2(self) -> tuple[float, float, float]:
        hx, hy, hz = self.mesh.h
        return (1.0 / hx**2, 1.0 / hy**2, 1.0 / hz**2)

    @property
    def const_merged_diag(self) -> tuple[float, float, float]:
        """diag of det(J) * J^{-1} J^{-T} (uniform only); multiply by
        w3d(q) to get C(q)."""
        d = self.det_j
        return tuple(d * ih2 for ih2 in self.inv_h2)

    def det_per_cell(self) -> np.ndarray:
        """[n_cells] det(J_e) in cell order (ez, ey, ex), x fastest."""
        hx, hy, hz = self.mesh.h_axes()
        return (hz[:, None, None] * hy[None, :, None] * hx[None, None, :]).reshape(-1)

    def merged_diag_per_cell(self) -> np.ndarray:
        """[n_cells, 3] diag of det(J_e) J_e^{-1} J_e^{-T}: per-axis
        (hy hz / hx, hx hz / hy, hx hy / hz)."""
        hx, hy, hz = self.mesh.h_axes()
        HX, HY, HZ = hx[None, None, :], hy[None, :, None], hz[:, None, None]
        return np.stack(
            [(HY * HZ / HX).reshape(-1), (HX * HZ / HY).reshape(-1), (HX * HY / HZ).reshape(-1)],
            axis=-1,
        )

    def det_q_full(self) -> np.ndarray:
        """``[n_cells, n_q]`` det(J) per qpoint (constant per brick cell)."""
        return np.broadcast_to(self.det_per_cell()[:, None], (self.mesh.n_cells, self.n_q))

    def jxw_full(self, dtype=np.float64) -> np.ndarray:
        """``[n_cells, n_q]`` JxW table."""
        w = self.w3d.reshape(-1)
        return (self.det_q_full() * w[None, :]).astype(dtype)

    def q_points_phys(self) -> np.ndarray:
        """``[n_cells, n_q, 3]`` physical quadrature points, cell order
        (ez,ey,ex) flattened, qpoint order (qz,qy,qx), x fastest."""
        mesh, basis = self.mesh, self.basis
        qp = basis.q_points
        edges = mesh.edges_1d()
        haxes = mesh.h_axes()
        ax, ay, az = [
            edges[d][:-1, None] + haxes[d][:, None] * qp[None, :] for d in range(3)
        ]  # [m_d, q1]
        mx, my, mz = mesh.n_elements
        q1 = basis.n_q
        X = np.zeros((mz, my, mx, q1, q1, q1, 3))
        X[..., 0] = ax[None, None, :, None, None, :]
        X[..., 1] = ay[None, :, None, None, :, None]
        X[..., 2] = az[:, None, None, :, None, None]
        return X.reshape(mesh.n_cells, self.n_q, 3)
