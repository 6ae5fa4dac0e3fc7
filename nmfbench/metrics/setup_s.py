"""setup_s (s, end to end): process start to the window, by the host's
clock: imports, the kernel library (built on a checkout's first run), the
data made on the card and the warm-up fit."""


def read(ctx):
    return ctx["setup_s"]
