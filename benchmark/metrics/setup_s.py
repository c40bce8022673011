"""setup_s: process start to the first timed unit (imports, inputs, the program's set-up, builds, warm-up)."""


def read(r):
    return r.setup_s
