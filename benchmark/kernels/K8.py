"""K8, the merged CG's seven-dot pass (``ops/cg_merged.py``, ``csrc/cg_merged.cu``),
one launch with its last block's fixed-order finish.

An iteration's call reads d, g and h once: 3 vectors, the seven sums' 14
operations a point. A solve's first call (g.g) reads g: 1 vector.
``units`` solves make ``units`` first calls.
"""

from benchmark.roofline import bound_s as _bound

MATCH = "dots_kernel"


def bound_s(ctx, calls, units):
    n, s, c = ctx["n"], ctx["vector_bytes"], ctx["compute"]
    return (calls - units) * _bound(3 * n * s, 14 * n, c) + units * _bound(n * s, 2 * n, c)
