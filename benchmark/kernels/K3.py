"""K3, the q-grid apply (``ops/qgrid.py``, ``csrc/qgrid.cu``), constrained,
one launch an apply.

Bytes: u read and out written once, and the q-point planes it streams (a
value table ``a(x_q) det``: one plane of ``E q^3`` numbers at the compute
type; a uniform brick's gradient term is three constants). Operations: the
sum factorisation's ``2 (2 q P^3 + 3 q^2 P^2 + 4 q^3 P)`` multiply-adds an
element, P = p + 1, and 4 products a q point.
"""

from math import prod

from benchmark.roofline import bound_s as _bound

MATCH = "qgrid_kernel"


def bound_s(ctx, calls, units):
    n, p1, q = ctx["n"], ctx["degree"] + 1, ctx["n_q"]
    n_el = prod(ctx["n_elements"])
    planes = 1 if ctx["value_table"] else 0
    n_bytes = 2 * n * ctx["vector_bytes"] + planes * n_el * q**3 * ctx["coef_bytes"]
    flops = n_el * (4 * (2 * q * p1**3 + 3 * q**2 * p1**2 + 4 * q**3 * p1) + 4 * q**3)
    return calls * _bound(n_bytes, flops, ctx["compute"])
