"""Preconditioner "identity": no diagonal on either side (plain CG)."""

from __future__ import annotations

DIAGONAL = False  # whether ``program`` gives a vector: K7 and K8 count its reads


def program(op):
    """The diagonal handed to ``solve_cg_merged(..., diag=)``: none."""
    return None


def reference(ref_op, dtype):
    """The diagonal the reference CG multiplies the residual by: none."""
    return None
