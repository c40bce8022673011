from . import cg, cg_merged, copy, general, local_global, qgrid, separable, stencil, sum_factorization

__all__ = ["cg", "cg_merged", "copy", "general", "local_global", "qgrid", "separable", "stencil", "sum_factorization"]
