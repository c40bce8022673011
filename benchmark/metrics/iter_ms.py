"""iter_ms: the solves' wall time over their iterations, before the traced stretch (the profiler
leaves the host slower)."""


def read(r):
    units = [u for u in r.units if u.phase == "clean"]
    if r.kind != "cg" or not units:
        return None
    return 1e3 * sum(u.seconds for u in units) / sum(u.work for u in units)
