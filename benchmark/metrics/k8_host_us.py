"""k8_host_us: host time of one call of K8's wrapper (``merged_dots``) in the merged CG's loop: the
program's span ``cg.dots`` over the traced stretch, the profiler's own cost in it."""

from benchmark.metrics.k7_host_us import span_us


def read(r):
    return span_us(r, "cg.dots")
