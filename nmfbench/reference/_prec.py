"""Precision of the plain references: float64 (the yardstick) or float32
whose every product takes TF32 operands (the control).

TF32 keeps 10 of float32's 23 mantissa bits.  The control rounds both
operands of every matrix product to TF32 (round to nearest, ties to even)
and multiplies them with float32 accumulation, which is what a TF32
tensor-core product computes; done by rounding, it gives the same numbers
on the CPU, where there is no TF32, and on the card.
"""
from __future__ import annotations

import contextlib

import torch


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32's 10-bit mantissa (nearest, ties to
    even), as float32."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


class Prec:
    """Where and how a reference computes: ``dtype`` (float64, or float32
    for the control), whether products take TF32 operands, and the
    magnitude below which a factor entry is 0 (``underflow``; None: the
    dtype's own)."""

    def __init__(self, dtype=torch.float64, tf32: bool = False, underflow=None):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 products are a float32 control")
        self.dtype = dtype
        self.tf32 = tf32
        self.underflow = underflow

    def flush(self, t):
        if self.underflow is None:
            return t
        return torch.where(t.abs() < self.underflow, torch.zeros_like(t), t)

    def mm(self, a, b):
        if self.tf32:
            return round_tf32(a) @ round_tf32(b)
        return a @ b

    def cast(self, t):
        return t.to(self.dtype)


F64 = Prec(torch.float64)
CONTROL = Prec(torch.float32, tf32=True)


@contextlib.contextmanager
def exact_products():
    """TF32 off for the library's products, so that a float32 product of
    TF32-rounded operands is the control's and nothing rounds further."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def row_blocks(m: int, n: int, budget_bytes: int = 1 << 30):
    """Slices of about ``budget_bytes`` of float64 (m, n) rows each."""
    rows = max(1, min(m, budget_bytes // (8 * max(n, 1))))
    return [slice(s, min(s + rows, m)) for s in range(0, m, rows)]
