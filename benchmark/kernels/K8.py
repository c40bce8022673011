"""K8, the merged CG's seven-dot pass (``ops/cg_merged.py``, ``csrc/cg_merged.cu``),
one launch with its last block's fixed-order finish.

An iteration's call reads d, g and h once: 3 vectors, the seven sums' 14
operations a point; with a diagonal it also reads diag, and forms diag h
and diag g: 4 vectors, 16 operations. A solve's first call (g.g, no
diagonal) reads g: 1 vector. g and h are at the vectors' type; d and the
diagonal (``diag_bytes``, 0 for none) at the wider of the vectors' type
and the diagonal's, as in K7. ``units`` solves make ``units`` first calls.
"""

from benchmark.roofline import bound_s as _bound

MATCH = "dots_kernel"


def bound_s(ctx, calls, units):
    n, s, m, c = ctx["n"], ctx["vector_bytes"], ctx["diag_bytes"], ctx["compute"]
    step = _bound(n * (2 * s + max(s, m) + m), n * (14 + 2 * (m > 0)), c)
    return (calls - units) * step + units * _bound(n * s, 2 * n, c)
