"""Carry the JAX package's state across to the port.

Vectors need no conversion: both packages order the real DoFs z slowest
over ``[nz, ny, nx]``. The stencil tables do: the JAX ``StencilLayout``
keeps its host copies (``sz_np`` ... ``bx_np``) in its padded coordinates
(z offset ``p``, y offset ``YOFF = 8``, x offset 0 and x padded to a
multiple of 128, taps on the leading axis); the port's K1 takes unpadded
``[n_d, 2p+1]`` band tables and ``[n_d]`` scaling vectors. The q-grid
tables of a JAX ``QGridLayout`` (``C [K, ZQ, YQ, MXQ]``, ``a_q [ZQ, YQ,
MXQ]``) put element ``e``'s q points at ``e*q`` on every axis and pad the
tail (z and y to whole blocks, x to 128 lanes); the port's K3 takes the
same tables without the padding, stored at the layout's
``coef_stream_dtype``. The Helmholtz value table of a JAX stencil
operator (``_a``, from ``StencilLayout.pad_node_field``) starts at the
origin of an output-tile-aligned box; the fused CG state of the JAX
``CGFusedStep`` is ``[4, zt, yt, nxp]`` in the vector layout's padded
coordinates. The port cuts both to the real grid. The banded tables of a
JAX ``BandedLayout`` (``mx_np`` ... ``bzg_np``, ``[2p+1, n_padded]``, taps
leading) sit at offset 0 in x, ``YOFF`` in y and ``p`` in z; the port's K2
takes them cut to the real rows and transposed to ``[n_d, 2p+1]``. A JAX
``GeneralCellKernel`` holds dense ``V``/``G_d`` tables ``[(p+1)^3, q^3]``
and its streamed coefficients padded to whole element blocks (``C [K, Ep,
Q]``, ``av [Ep, Q]``); the port's K4 takes the 1D ``S``/``D`` tables of the
same basis and the coefficients cut to the ``E`` real cells.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "JAX_STENCIL_YOFF",
    "banded_tables_from_jax",
    "cg_state_from_jax",
    "general_tables_from_jax",
    "qgrid_tables_from_jax",
    "stencil_tables_from_jax",
    "stencil_value_from_jax",
]

JAX_STENCIL_YOFF = 8  # pallas_stencil.YOFF: the y front pad of the TPU layout


def stencil_tables_from_jax(sz_np, sy_np, sx_np, bz_np, by_np, bx_np, p, real_shape):
    """The port's tables (``ops.stencil.stencil_tables_np`` keys) from the
    padded host copies of a JAX ``StencilLayout`` with degree ``p`` and
    ``real_shape = (nz, ny, nx)``."""
    nz, ny, nx = real_shape
    zs, ys, xs = slice(p, p + nz), slice(JAX_STENCIL_YOFF, JAX_STENCIL_YOFF + ny), slice(0, nx)
    out = {}
    for name, s, b, sl in (("z", sz_np, bz_np, zs), ("y", sy_np, by_np, ys), ("x", sx_np, bx_np, xs)):
        out["s" + name] = np.asarray(s, dtype=np.float64)[sl].copy()
        out["b" + name] = np.ascontiguousarray(np.asarray(b, dtype=np.float64)[:, sl].T)
    return out


def stencil_value_from_jax(a_pad, real_shape) -> np.ndarray:
    """The port's value table ``[nz, ny, nx]`` (float64) from a JAX
    stencil operator's padded ``_a``."""
    nz, ny, nx = real_shape
    return np.ascontiguousarray(np.asarray(a_pad, dtype=np.float64)[:nz, :ny, :nx])


def cg_state_from_jax(s, p, real_shape) -> np.ndarray:
    """The port's stacked CG state ``[4, nz, ny, nx]`` (planes D, G, H, X)
    from a JAX stacked state ``[4, zt, yt, nxp]`` of degree ``p``, at its
    own dtype."""
    nz, ny, nx = real_shape
    y0 = JAX_STENCIL_YOFF
    return np.ascontiguousarray(np.asarray(s)[:, p : p + nz, y0 : y0 + ny, :nx])


def qgrid_tables_from_jax(layout) -> dict:
    """The port's K3 tables (``ops.qgrid.qgrid_tables_np`` keys, float64)
    from a JAX ``QGridLayout``: its streamed tables, read as numpy arrays
    and cut to the real q grid, its const scalars and its basis, and the
    storage dtype of its streams (``coef_dtype``: None when they are stored
    at the vectors' dtype, else its name, "bfloat16" for
    ``coef_stream_dtype=bfloat16``; the float64 copies hold the bf16 values
    exactly, so ``QGridTables.from_numpy`` stores the same bits)."""
    mx, my, mz = layout.mesh.n_elements
    q = layout.q
    real = (slice(0, mz * q), slice(0, my * q), slice(0, mx * q))

    def cut(a, lead=()):
        return None if a is None else np.ascontiguousarray(np.asarray(a, dtype=np.float64)[lead + real])

    return {
        "p": layout.p, "q": q, "n_elements": (mx, my, mz),
        "S": np.asarray(layout.S_np, dtype=np.float64), "D": np.asarray(layout.D_np, dtype=np.float64),
        "w": np.asarray(layout.w_np, dtype=np.float64),
        "grad_kind": int(layout.grad_kind), "val_kind": int(layout.val_kind),
        "c_grad": tuple(layout.c_grad) if layout.c_grad is not None else (0.0, 0.0, 0.0),
        "c_val": float(layout.c_val) if layout.c_val is not None else 0.0,
        "C": cut(layout.C, (slice(None),)), "a_q": cut(layout.a_q),
        "coef_dtype": None if layout.coef_dtype == layout.dtype else layout.coef_dtype.name,
    }


def banded_tables_from_jax(layout) -> dict:
    """The port's K2 tables (``ops.banded.banded_tables_np`` keys, float64)
    from the padded host copies of a JAX ``BandedLayout`` (its ``kind``
    picks the keys: ``mx, ax, my, ay, mz, gz`` or ``mx, my, gz``)."""
    p = layout.p
    nz, ny, nx = layout.real_shape
    cuts = {"x": slice(0, nx), "y": slice(JAX_STENCIL_YOFF, JAX_STENCIL_YOFF + ny), "z": slice(p, p + nz)}
    src = {"mx": layout.mx_np, "ax": layout.ax_np, "my": layout.my_np, "ay": layout.ay_np,
           "mz": layout.mz_np, "gz": layout.bzg_np}
    keys = ("mx", "ax", "my", "ay", "mz", "gz") if layout.kind == "stiffness" else ("mx", "my", "gz")
    return {k: np.ascontiguousarray(np.asarray(src[k], dtype=np.float64)[:, cuts[k[1]]].T) for k in keys}


def general_tables_from_jax(kernel, basis) -> dict:
    """The port's K4 tables (``ops.general.general_tables_np`` keys,
    float64) from a JAX ``GeneralCellKernel`` built on ``basis``: the 1D
    ``S``/``D`` of the basis (checked against the kernel's dense tables, so
    a basis or index-order mismatch raises), ``cw``/``vw`` as they are, and
    the streamed ``C``/``av`` cut to the real cells."""
    from ..basis import basis_tables_3d

    E = int(kernel._E)
    tabs, streamed = kernel._tabs, kernel._streamed
    V, G = basis_tables_3d(basis)
    dense = [("G", np.asarray(g, dtype=np.float64), G[d]) for d, g in enumerate(tabs.get("G", ()))]
    if "V" in tabs:
        dense.append(("V", np.asarray(tabs["V"], dtype=np.float64), V))
    for name, have, want in dense:
        if have.shape != want.shape or not np.allclose(have, want, rtol=1e-6, atol=1e-6 * np.abs(want).max()):
            raise ValueError(f"general_tables_from_jax: the kernel's {name} table is not the basis's")

    def host(a):
        return None if a is None else np.ascontiguousarray(np.asarray(a, dtype=np.float64))

    return {
        "p": basis.degree, "q": basis.n_q, "n_cells": E,
        "grad_kind": int(kernel.grad_kind), "val_kind": int(kernel.val_kind),
        "S": np.asarray(basis.S, dtype=np.float64), "D": np.asarray(basis.D, dtype=np.float64),
        "cw": host(tabs.get("cw")),
        "C": host(np.asarray(streamed["C"])[:, :E]) if "C" in streamed else None,
        "vw": host(np.asarray(tabs["vw"]).reshape(-1)) if "vw" in tabs else None,
        "av": host(np.asarray(streamed["av"])[:E]) if "av" in streamed else None,
    }
