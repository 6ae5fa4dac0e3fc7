"""device_idle (%): the share of the traced window in which no kernel,
memcpy or memset ran on the card (the union of their intervals, not the
sum).  Layer: device."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
