"""Fused objective passes: a CUDA kernel each, with its plain version beside it.

  * ``eu_residual_obj`` : 0.5 * ||X - WH||_F^2   (kernel: csrc/objective.cu)
  * ``kl_obj``          : masked KL objective   (kernel: csrc/objective.cu)
  * ``kl_ratio_and_obj``: (X / (WH + eps), masked KL objective) from one
    pass (kernel: csrc/objective.cu); ADMM's KL objective
  * ``kl_ratio``        : plain PyTorch only, for MUR's plain KL route; its
    kernel is still to be ported (ROADMAP.md, queue 2)

A wrapper takes its plain version (``*_ref``) only for a tensor on the CPU;
for a CUDA tensor it launches its kernel or raises.  Each wrapper counts
its launches in ``<wrapper>.launches``.

The plain versions round the same operands to the same types as the
kernels: X (float32 or bfloat16) is upcast to the factors' type, and WH is
formed in that type.
"""
from __future__ import annotations

import torch

from ..core.losses import kl_elementwise_sum
from ..core.precision import full_f32
from . import _build
from ._launch import call, check_operands, on_cpu

_EPS = 1e-9


@full_f32()
def eu_residual_obj_ref(x, w, h):
    """Plain version of :func:`eu_residual_obj`."""
    d = x.to(w.dtype) - w @ h
    return 0.5 * torch.sum(d * d)


@full_f32()
def kl_obj_ref(x, w, h):
    """Plain version of :func:`kl_obj` (reference nmf/utils.py:21-26)."""
    return kl_elementwise_sum(x.to(w.dtype), w @ h)


def _objective(name, x, w, h, is_kl):
    m, n, k = check_operands(name, x, w, h)
    lib = _build.library()
    partials = torch.empty(lib.tpunmf_objective_blocks(m, n),
                           dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    call("tpunmf_objective", x.device, x.data_ptr(),
         int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr(),
         m, n, k, int(is_kl), partials.data_ptr(), out.data_ptr())
    return out


def eu_residual_obj(x, w, h):
    """0.5 * ||x - w @ h||_F^2 without materializing w @ h."""
    if on_cpu(x):
        return eu_residual_obj_ref(x, w, h)
    out = _objective("eu_residual_obj", x, w, h, is_kl=False)
    eu_residual_obj.launches += 1
    return out


def kl_obj(x, w, h):
    """Masked KL objective in one fused sweep."""
    if on_cpu(x):
        return kl_obj_ref(x, w, h)
    out = _objective("kl_obj", x, w, h, is_kl=True)
    kl_obj.launches += 1
    return out


eu_residual_obj.launches = 0
kl_obj.launches = 0


def kl_ratio(x, w, h, *, eps: float = _EPS):
    """x / (w @ h + eps) (MUR-KL ratio, nmf/mur.py:25)."""
    return x / (w @ h + eps)


@full_f32()
def kl_ratio_and_obj_ref(x, w, h, *, eps: float = _EPS):
    """Plain version of :func:`kl_ratio_and_obj`: the ratio takes the eps,
    the KL term the raw product (tpunmf/ops/fused.py:260-265)."""
    x = x.to(w.dtype)
    wh = w @ h
    return x / (wh + eps), kl_elementwise_sum(x, wh)


def kl_ratio_and_obj(x, w, h, *, eps: float = _EPS):
    """(x / (w @ h + eps) as an m x n float32 tensor, masked KL objective),
    from one fused sweep."""
    if on_cpu(x):
        return kl_ratio_and_obj_ref(x, w, h, eps=eps)
    m, n, k = check_operands("kl_ratio_and_obj", x, w, h)
    lib = _build.library()
    ratio = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partials = torch.empty(lib.tpunmf_objective_blocks(m, n),
                           dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    call("tpunmf_kl_ratio_obj", x.device, x.data_ptr(),
         int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr(), m, n, k,
         float(eps), ratio.data_ptr(), partials.data_ptr(), out.data_ptr())
    kl_ratio_and_obj.launches += 1
    return ratio, out


kl_ratio_and_obj.launches = 0
