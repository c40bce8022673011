"""iterations: the mean of the solver's own iteration count over the window's solves."""


def read(r):
    if r.kind != "cg" or not r.units:
        return None
    return sum(u.work for u in r.units) / len(r.units)
