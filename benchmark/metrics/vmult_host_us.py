"""vmult_host_us: host time of one call of the operator's vmult inside the solves: the program's span
``op.vmult`` over the traced stretch, the profiler's own cost in it (``apply_host_us`` times the same
call from outside, before the stretch)."""

from benchmark.metrics.k7_host_us import span_us


def read(r):
    return span_us(r, "op.vmult")
