from . import cg, copy, local_global, qgrid, separable, stencil, sum_factorization

__all__ = ["cg", "copy", "local_global", "qgrid", "separable", "stencil", "sum_factorization"]
