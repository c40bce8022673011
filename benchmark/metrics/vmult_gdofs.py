"""vmult_gdofs: DoFs times the applies completed over the window's seconds, in 10^9 a second."""


def read(r):
    if r.kind != "vmult" or not r.units:
        return None
    return r.ctx["n"] * sum(u.work for u in r.units) / r.window_s / 1e9
