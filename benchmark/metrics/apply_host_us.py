"""apply_host_us: host time of one call of the operator's vmult as the solver makes it (the
benchmark's span, no fence), before the traced stretch."""


def read(r):
    if r.kind != "cg" or r.apply_calls == 0:
        return None
    return r.apply_ns / r.apply_calls / 1e3
