from . import local_global, qgrid, separable, stencil, sum_factorization

__all__ = ["local_global", "qgrid", "separable", "stencil", "sum_factorization"]
