"""step_mfu (%): one iteration's product FLOPs (work/<method>.py) times
the iterations of the traced window, over the window's seconds times the
published dense TF32 peak, 495 TFLOP/s.  Layer: solver step.  No f32
route can read above 100% against it."""

from nmfbench.harness.peaks import PEAK_TF32


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["iterations"] <= 0:
        return None
    flops = ctx["work"]["product_flops"] + ctx["work"]["bf16_flops"]
    return 100.0 * flops * ctx["iterations"] / (ctx["window_s"] * PEAK_TF32)
