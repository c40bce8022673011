"""cg_kernels_roofline: the merged CG's own kernels' (K7, K8) least time over their device time
in the traced stretch."""

from benchmark.metrics.apply_roofline import share


def read(r):
    labels = list(r.cell.kind.SOLVER_KERNELS)
    return share(r, labels) if labels else None
