from . import cg, copy, general, local_global, qgrid, separable, stencil, sum_factorization

__all__ = ["cg", "copy", "general", "local_global", "qgrid", "separable", "stencil", "sum_factorization"]
