"""K7, the merged CG's update pass (``ops/cg_merged.py``, ``csrc/cg_merged.cu``),
with the identity preconditioner.

An iteration's call (x += a d, g += a h, d = -g + b d) reads x, g, d, h and
writes x, g, d: 7 vectors, 6 operations a point. A solve's first call
(``init``: d = -g) reads g and writes d: 2 vectors. ``units`` solves make
``units`` first calls.
"""

from benchmark.roofline import bound_s as _bound

MATCH = "update_kernel"


def bound_s(ctx, calls, units):
    n, s, c = ctx["n"], ctx["vector_bytes"], ctx["compute"]
    return (calls - units) * _bound(7 * n * s, 6 * n, c) + units * _bound(2 * n * s, n, c)
