"""launches_per_iter (1/it): kernels that started in the traced window over
its iterations.  Layer: solver step."""


def read(ctx):
    if ctx["iterations"] <= 0:
        return None
    return ctx["kernels"] / ctx["iterations"]
