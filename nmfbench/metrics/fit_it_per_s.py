"""fit_it_per_s (it/s, end to end): the iterations of all fits completed in
the window over the window's seconds, by the host's clock."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return ctx["iterations"] / ctx["window_s"]
