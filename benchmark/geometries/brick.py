"""Geometry "brick": a uniform brick from the mesh's bounds (``mesh``:
``n_elements`` [mx, my, mz], ``lower``, ``upper``), Q_p on GLL nodes.

The program's mesh is ``deal_and_ceed_on_gpu_torch.mesh.BrickMesh``; the
reference's operator is ``reference/brick.BrickOperator``, worked out from
the same numbers and nothing of the program.
"""

from __future__ import annotations

from benchmark.reference.brick import BrickOperator


def program_mesh(cfg: dict):
    """The port's mesh of the configuration, through its public API."""
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh

    m = cfg["mesh"]
    return BrickMesh(tuple(m["n_elements"]), tuple(float(v) for v in m["lower"]), tuple(float(v) for v in m["upper"]))


def reference_operator(cfg: dict, dtype, device, scale: float) -> BrickOperator:
    """The plain reference's operator, its unconstrained rows scaled by ``scale``."""
    return BrickOperator(cfg["mesh"], cfg["degree"], cfg["n_q"], cfg["rule"], cfg.get("coefficient"), dtype, device,
                         scale)


def n_dofs(cfg: dict) -> int:
    """The grid's points, ``(mx p + 1)(my p + 1)(mz p + 1)``."""
    mx, my, mz = cfg["mesh"]["n_elements"]
    p = cfg["degree"]
    return (mx * p + 1) * (my * p + 1) * (mz * p + 1)


def small(cfg: dict, n_elements) -> dict:
    """The configuration on at most ``n_elements`` (x, y, z) elements of the
    same size, from the origin."""
    m = cfg["mesh"]["n_elements"]
    cut = [min(v, k) for v, k in zip(m, n_elements)]
    h = [(hi - lo) / v for lo, hi, v in zip(cfg["mesh"]["lower"], cfg["mesh"]["upper"], m)]
    return {**cfg, "mesh": {"n_elements": cut, "lower": [0.0] * 3, "upper": [hh * v for hh, v in zip(h, cut)]}}
