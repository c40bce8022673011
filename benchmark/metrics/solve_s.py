"""solve_s: time to solution, the window's wall time over the solves it completed."""


def read(r):
    if r.kind != "cg" or not r.units:
        return None
    return r.window_s / len(r.units)
