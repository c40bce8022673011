"""step_roofline: a whole unit's least device time (every kernel of its path at its bound) over
its wall time, for the units before the traced stretch."""


def read(r):
    units = [u for u in r.units if u.phase == "clean"]
    if not units:
        return None
    return 100.0 * sum(r.unit_bound_s(u.work) for u in units) / sum(u.seconds for u in units)
