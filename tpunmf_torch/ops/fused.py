"""Fused objective passes: a CUDA kernel each, with its plain version beside it.

  * ``eu_residual_obj`` : 0.5 * ||X - WH||_F^2   (kernel: csrc/objective.cu)
  * ``kl_obj``          : masked KL objective   (kernel: csrc/objective.cu)
  * ``kl_ratio_and_obj``: (X / (WH + eps), masked KL objective) from one
    pass (kernel: csrc/objective.cu); ADMM's KL objective, and the
    trailing pass of MUR's high-rank KL step
  * ``kl_ratio``        : X / (WH + eps) as an m x n float32 tensor
    (kernel: csrc/objective.cu, ``kl_ratio_and_obj``'s body without the
    sum, so the same ratio bit for bit); the ratio pass of MUR's
    high-rank KL step

All four run one kernel body: WH on the tensor cores in 3xTF32
(``csrc/tf32x3.cuh``: f32 accuracy at 165 TFLOP/s of f32 work on the
H100) on 128 x 128 tiles, X read 16 bytes at a time, and per-tile partial
sums added in a fixed order.  The objectives store no ratio; ``kl_obj``
gives ``kl_ratio_and_obj``'s objective bit for bit.  Products bound the
objectives at k 128 and above, bytes at ``tpunmf``'s config[1] (k 50);
the ratio passes also write the ratio, so at ADMM's config[3] bytes bound
them, at MUR's high rank the products.

A wrapper takes its plain version (``*_ref``) only for a tensor on the CPU;
for a CUDA tensor it launches its kernel or raises.  Each wrapper counts
its launches in ``<wrapper>.launches``.  ``objective_takes`` says which X
and ranks the kernels take: float32 or bfloat16 X at 1 <= k <= 2048 (the
kernels stage k in chunks of 32 and hold nothing sized by it; 2048 is
``tpunmf``'s own cut, tpunmf/ops/fused.py:52).  A solver asks it before it
calls a wrapper.

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
OBJECTIVE_MAX_RANK = 2048


def objective_takes(x, k: int) -> bool:
    """Whether this module's kernels take X of this dtype at rank k (with
    float32 factors): float32 or bfloat16 X, 1 <= k <= 2048.  ``x`` is
    anything with ``.dtype`` (a ``meta`` tensor will do)."""
    return x.dtype in (torch.float32, torch.bfloat16) and 1 <= k <= OBJECTIVE_MAX_RANK


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
    m, n, k = check_operands(name, x, w, h, max_rank=OBJECTIVE_MAX_RANK)
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


@full_f32()
def kl_ratio_ref(x, w, h, *, eps: float = _EPS):
    """Plain version of :func:`kl_ratio`."""
    return x.to(w.dtype) / (w @ h + eps)


def kl_ratio(x, w, h, *, eps: float = _EPS):
    """x / (w @ h + eps) as an m x n float32 tensor, w @ h formed a tile at
    a time and never stored (MUR-KL ratio, nmf/mur.py:25)."""
    if on_cpu(x):
        return kl_ratio_ref(x, w, h, eps=eps)
    m, n, k = check_operands("kl_ratio", x, w, h, max_rank=OBJECTIVE_MAX_RANK)
    ratio = torch.empty((m, n), dtype=torch.float32, device=x.device)
    call("tpunmf_kl_ratio", x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
         w.data_ptr(), h.data_ptr(), m, n, k, float(eps), ratio.data_ptr())
    kl_ratio.launches += 1
    return ratio


kl_ratio.launches = 0


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
    m, n, k = check_operands("kl_ratio_and_obj", x, w, h,
                             max_rank=OBJECTIVE_MAX_RANK)
    lib = _build.library()
    ratio = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partials = torch.empty(lib.tpunmf_ratio_blocks(m, n),
                           dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    call("tpunmf_kl_ratio_obj", x.device, x.data_ptr(),
         int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr(), m, n, k,
         float(eps), ratio.data_ptr(), partials.data_ptr(), out.data_ptr())
    kl_ratio_and_obj.launches += 1
    return ratio, out


kl_ratio_and_obj.launches = 0
