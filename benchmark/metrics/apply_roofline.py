"""apply_roofline: the apply kernel's (the configuration's ``apply_kernel``: K1, K3) least time
over its device time in the traced stretch."""

from benchmark import roofline


def share(r, labels):
    """100 x the least seconds of the ``labels`` kernels' launches in the
    stretch over their device seconds; None where the stretch ran one of
    them not at all."""
    if r.stretch is None or not all(label in r.stretch["kernels"] for label in labels):
        return None
    found = [(label, *r.stretch["kernels"][label]) for label in labels]
    seconds = sum(s for _, _, s in found)
    if seconds <= 0:
        return None
    bound = sum(roofline.kernel(label).bound_s(r.ctx, calls, r.stretch_units) for label, calls, _ in found)
    return 100.0 * bound / seconds


def read(r):
    return share(r, [r.cell.config["apply_kernel"]])
