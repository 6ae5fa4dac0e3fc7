"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W), and the least time a step's work could take on it.

Three classes of operations, as the port's ops/roofline.py has them
(frozen here, so that a change to the program cannot move the yardstick):
f32 elementwise work at the f32 FMA rate; bf16 products on the tensor
cores; f32 products at 3xTF32, the least time an f32-accurate product
takes (three TF32 products, 495 / 3 TFLOP/s), whichever unit does it.
"""
from __future__ import annotations

PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32_PRODUCT = PEAK_TF32 / 3
PEAK_BYTES = 3.35e12


def bound_s(work: dict) -> float:
    """Seconds: the larger of the operations over their peaks and the bytes
    over the memory rate."""
    ops = (work["f32_flops"] / PEAK_F32 + work["bf16_flops"] / PEAK_BF16
           + work["product_flops"] / PEAK_F32_PRODUCT)
    return max(ops, work["bytes"] / PEAK_BYTES)


def bound_by(work: dict) -> str:
    """"operations" or "bytes": what sets :func:`bound_s`."""
    ops = (work["f32_flops"] / PEAK_F32 + work["bf16_flops"] / PEAK_BF16
           + work["product_flops"] / PEAK_F32_PRODUCT)
    return "operations" if ops >= work["bytes"] / PEAK_BYTES else "bytes"
