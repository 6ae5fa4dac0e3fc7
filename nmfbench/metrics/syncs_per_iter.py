"""syncs_per_iter (1/it): runtime calls in the traced window that block the
host until the card is done (stream, event or device synchronisation, the
synchronous copies) over its iterations.  Layer: loop driver."""


def read(ctx):
    if ctx["iterations"] <= 0:
        return None
    return ctx["syncs"] / ctx["iterations"]
