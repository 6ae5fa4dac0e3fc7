"""Masked (weighted) MUR half-updates: a CUDA kernel each, with its plain
version beside it (csrc/masked_update.cu; tpunmf/ops/masked_fused.py).

    EU:  W <- W * ((M*X) H^T) / ((M*(W H)) H^T + lam W + eps)
    KL:  a = W * ((M*X / (W H + eps)) H^T),  b = M H^T,
         den = b + sqrt(b^2 + 4 lam a);  W <- where(den > 0, 2a / den, W)

and the mirror for H (with the already-updated W).  The KL guard keeps
the factor entries of a fully unobserved row (column); EU has no guard
(a cold row's entries go to 0), as in ``tpunmf``.

Rounding follows the TPU kernels and differs from the unmasked EU ones:
X and M are upcast to the factors' type and the factor is NOT rounded to
X's dtype (masked_fused.py:86-92, 182-188).  ``M`` is either 1-byte
(``torch.uint8`` or ``torch.bool``, a binary mask) or of X's dtype (a
real-valued weight mask); X is float32 or bfloat16 on CUDA, at ranks up
to 1024 (``masked_takes``).

A wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.  ``<wrapper>.launches``
counts the launches.
"""
from __future__ import annotations

import torch

from ..core.precision import full_f32
from ._launch import MAX_RANK, call, check_operands, on_cpu

_EPS = 1e-9
_BYTE_MASKS = (torch.uint8, torch.bool)


def masked_takes(x, k: int) -> bool:
    """Whether the masked kernels take X of this dtype at rank k: float32
    or bfloat16 X, 1 <= k <= 1024 (``tpunmf``'s ``masked_tileable`` gives
    no tile above 1024 either).  A solver asks this before it calls a
    wrapper; ``x`` is anything with ``.dtype`` (a ``meta`` tensor will do)."""
    return x.dtype in (torch.float32, torch.bfloat16) and 1 <= k <= MAX_RANK


def _guarded(num2, den, old):
    """where(den > 0, num2 / den, old): a cold row keeps its entries."""
    pos = den > 0
    return torch.where(pos, num2 / torch.where(pos, den, torch.ones_like(den)), old)


@full_f32()
def masked_w_update_ref(x, mask, w, h, *, distance_type: str, lam: float):
    """Plain version of :func:`masked_w_update` (tpunmf/solvers/masked.py:79-108)."""
    xf, mf = x.to(w.dtype), mask.to(w.dtype)
    wh = w @ h
    if distance_type == "eu":
        return w * ((mf * xf) @ h.T) / ((mf * wh) @ h.T + lam * w + _EPS)
    a = w * ((mf * xf / (wh + _EPS)) @ h.T)
    b = mf @ h.T
    return _guarded(2.0 * a, b + torch.sqrt(b * b + 4.0 * lam * a), w)


@full_f32()
def masked_h_update_ref(x, mask, w, h, *, distance_type: str, lam: float):
    """Plain version of :func:`masked_h_update`."""
    xf, mf = x.to(h.dtype), mask.to(h.dtype)
    wh = w @ h
    if distance_type == "eu":
        return h * (w.T @ (mf * xf)) / (w.T @ (mf * wh) + lam * h + _EPS)
    c = h * (w.T @ (mf * xf / (wh + _EPS)))
    d = w.T @ mf
    return _guarded(2.0 * c, d + torch.sqrt(d * d + 4.0 * lam * c), h)


def _run_kernel(name, x, mask, w, h, distance_type, lam):
    """Check the operands and launch C entry ``tpunmf_<name>``."""
    if distance_type not in ("eu", "kl"):
        raise KeyError(f"Unknown distance type {distance_type!r}")
    m, n, k = check_operands(name, x, w, h, max_rank=MAX_RANK)
    if mask.shape != x.shape or mask.device != x.device:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} on {mask.device} does "
                         f"not match x {tuple(x.shape)} on {x.device}")
    if mask.dtype not in (*_BYTE_MASKS, x.dtype):
        raise TypeError(f"{name}: mask must be uint8, bool or x's dtype "
                        f"({x.dtype}), got {mask.dtype}")
    if not mask.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")
    out = torch.empty(h.shape if name == "masked_h_update" else w.shape,
                      dtype=torch.float32, device=x.device)
    call(f"tpunmf_{name}", x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
         mask.data_ptr(), int(mask.dtype in _BYTE_MASKS), w.data_ptr(),
         h.data_ptr(), float(lam), m, n, k, int(distance_type == "kl"),
         out.data_ptr())
    return out


@full_f32()
def masked_w_update(x, mask, w, h, *, distance_type: str, lam: float):
    """One fused pass over (X, M) producing the masked-updated W (m, k)."""
    if on_cpu(x):
        return masked_w_update_ref(x, mask, w, h, distance_type=distance_type,
                                   lam=lam)
    out = _run_kernel("masked_w_update", x, mask, w, h, distance_type, lam)
    masked_w_update.launches += 1
    return out


@full_f32()
def masked_h_update(x, mask, w, h, *, distance_type: str, lam: float):
    """One fused pass over (X, M) producing the masked-updated H (k, n),
    from the already-updated W (tpunmf/solvers/masked.py sequencing)."""
    if on_cpu(x):
        return masked_h_update_ref(x, mask, w, h, distance_type=distance_type,
                                   lam=lam)
    out = _run_kernel("masked_h_update", x, mask, w, h, distance_type, lam)
    masked_h_update.launches += 1
    return out


masked_w_update.launches = 0
masked_h_update.launches = 0
