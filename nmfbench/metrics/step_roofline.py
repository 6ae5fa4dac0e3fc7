"""step_roofline (%): the least time one iteration's work could take on
the card (work/<method>.py's count against harness/peaks.py's bound) over
the device-busy time an iteration in the traced window.  Layer: kernels.
Whichever kernels do the work, the count is the method's."""


def read(ctx):
    if ctx["busy_s"] <= 0 or ctx["iterations"] <= 0:
        return None
    return 100.0 * ctx["bound_s"] * ctx["iterations"] / ctx["busy_s"]
