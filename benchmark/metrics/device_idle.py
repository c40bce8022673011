"""device_idle: the share of the traced stretch's wall time in which no operation ran on the device."""


def read(r):
    if r.stretch is None or r.stretch["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.stretch["busy_s"] / r.stretch["window_s"])
