"""K1, the stencil apply (``ops/stencil.py``, ``csrc/stencil.cu``): a uniform
brick with GLL collocation, one launch an apply.

Bytes: u read and out written once (``n`` points at the vectors' size).
Operations: 2 scalings and 3 (2p+1) multiply-adds a point, ``4 + 6 (2p+1)``.
"""

from benchmark.roofline import bound_s as _bound

MATCH = "stencil_kernel"


def bound_s(ctx, calls, units):
    n, p = ctx["n"], ctx["degree"]
    return calls * _bound(2 * n * ctx["vector_bytes"], n * (4 + 6 * (2 * p + 1)), ctx["compute"])
