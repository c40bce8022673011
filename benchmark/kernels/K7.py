"""K7, the merged CG's update pass (``ops/cg_merged.py``, ``csrc/cg_merged.cu``).

An iteration's call (x += a d, g += a h, d = b d - diag g) reads x, g, d, h
and writes x, g, d: 7 vectors, 6 operations a point; with a diagonal it
also reads diag and multiplies by it: 8 vectors, 7 operations. A solve's
first call (``init``: d = -diag g) reads g and writes d: 2 vectors, 1
operation; with a diagonal 3 vectors, 2 operations. g and h are at the
vectors' type; x, d and the diagonal (``diag_bytes``, 0 for none) at
torch's promotion of the vectors' type and the diagonal's, the wider of
the two. ``units`` solves make ``units`` first calls.
"""

from benchmark.roofline import bound_s as _bound

MATCH = "update_kernel"


def bound_s(ctx, calls, units):
    n, s, m, c = ctx["n"], ctx["vector_bytes"], ctx["diag_bytes"], ctx["compute"]
    xd = max(s, m)  # x and d
    step = _bound(n * (3 * s + 4 * xd + m), n * (6 + (m > 0)), c)
    init = _bound(n * (s + xd + m), n * (1 + (m > 0)), c)
    return (calls - units) * step + units * init
