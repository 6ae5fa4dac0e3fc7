"""The 2-pass fused MUR iteration: a CUDA kernel per half-update.

  W pass (``mur_w_update``, csrc/mur_update.cu):
      EU: W <- W * (X H^T) / (W Gh + lw W + eps)               (nmf/mur.py:29)
      KL: a = W * ((X / (W H + eps)) H^T), b = rowsum(H),
          W <- 2a / (b + sqrt(b^2 + 4 lw a))                   (nmf/mur.py:25-27)
      KL with ``with_lagged_obj``: also the masked KL objective of the
          INCOMING (W, H), summed from the same W H tiles (the lagged
          objective, tpunmf/ops/mur_fused.py:114-141)
  H pass (``mur_h_update``, csrc/mur_update.cu):
      EU: numer = W^T X, H <- H * numer / (Gw H + lh H + eps)
      KL: numer = W^T (X / (W H + eps)), c = H * numer, d = colsum(W),
          H <- 2c / (d + sqrt(d^2 + 4 lh c))
      and emits the raw numerator too (the Gram objective needs W^T X).

Only the k x k Grams ``Gh = H H^T`` / ``Gw = W^T W`` and the row/column
sums are formed outside the kernels, as ``tpunmf`` forms them outside its
Pallas bodies.  Outputs are new tensors: nothing is updated in place (the
EU epilogue of a row block reads all of W_i).

A wrapper takes its plain version (``*_ref``) only for a tensor on the
CPU; for a CUDA tensor it launches its kernel or raises.  Each wrapper
counts its launches in ``<wrapper>.launches``; the lagged W pass is a
kernel of its own and counts in ``mur_w_update.lagged_launches``.  The
plain versions round the same operands as the kernels: the EU products
cast the factor to X's dtype first (H^T for W, W^T for H), the KL
products upcast X instead.
"""
from __future__ import annotations

import torch

from ..core.losses import kl_elementwise_sum
from ..core.precision import full_f32
from . import _build
from ._launch import call, check_operands, on_cpu

_EPS = 1e-9


def _factor_as_x(f, x):
    """Round a factor to X's storage dtype, then compute in the factor's."""
    return f.to(x.dtype).to(f.dtype) if x.dtype != f.dtype else f


@full_f32()
def mur_w_update_ref(x, w, h, *, distance_type: str, lam: float,
                     with_lagged_obj: bool = False):
    """Plain version of :func:`mur_w_update`."""
    _check_lagged(distance_type, with_lagged_obj)
    xf = x.to(w.dtype)
    if distance_type == "eu":
        gh = h @ h.T
        numer = xf @ _factor_as_x(h, x).T
        return w * numer / (w @ gh + lam * w + _EPS)
    wh = w @ h
    r = xf / (wh + _EPS)
    a = w * (r @ h.T)
    b = torch.sum(h, dim=1)[None, :]
    w_new = 2.0 * a / (b + torch.sqrt(b * b + 4.0 * lam * a))
    if with_lagged_obj:
        return w_new, kl_elementwise_sum(xf, wh)
    return w_new


@full_f32()
def mur_h_update_ref(x, w, h, *, distance_type: str, lam: float):
    """Plain version of :func:`mur_h_update`: (H_new, numer)."""
    xf = x.to(w.dtype)
    if distance_type == "eu":
        gw = w.T @ w
        numer = _factor_as_x(w, x).T @ xf
        return h * numer / (gw @ h + lam * h + _EPS), numer
    r = xf / (w @ h + _EPS)
    numer = w.T @ r
    c = h * numer
    d = torch.sum(w, dim=0)[:, None]
    return 2.0 * c / (d + torch.sqrt(d * d + 4.0 * lam * c)), numer


def _check_distance(distance_type):
    if distance_type not in ("eu", "kl"):
        raise KeyError(f"Unknown distance type {distance_type!r}")
    return distance_type == "kl"


def _check_lagged(distance_type, with_lagged_obj):
    if with_lagged_obj and not _check_distance(distance_type):
        raise ValueError("lagged objective is a KL-only mode")


@full_f32()
def mur_w_update(x, w, h, *, distance_type: str, lam: float,
                 with_lagged_obj: bool = False):
    """One fused pass over X producing the updated W (m, k).

    With ``with_lagged_obj`` (KL only) returns ``(w_new, obj)``, obj the
    masked KL of the INCOMING (w, h) as a 0-d tensor: free, since the pass
    forms those W H tiles anyway."""
    is_kl = _check_distance(distance_type)
    _check_lagged(distance_type, with_lagged_obj)
    if on_cpu(x):
        return mur_w_update_ref(x, w, h, distance_type=distance_type, lam=lam,
                                with_lagged_obj=with_lagged_obj)
    check_operands("mur_w_update", x, w, h)
    aux = torch.sum(h, dim=1) if is_kl else h @ h.T
    m, n = x.shape
    k = w.shape[1]
    is_bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if with_lagged_obj:
        partials = torch.empty(_build.library().tpunmf_mur_w_lagged_blocks(m, k),
                               dtype=torch.float32, device=x.device)
        obj = torch.empty((), dtype=torch.float32, device=x.device)
        call("tpunmf_mur_w_update_lagged", x.device, x.data_ptr(), is_bf16,
             w.data_ptr(), h.data_ptr(), aux.data_ptr(), float(lam), m, n, k,
             out.data_ptr(), partials.data_ptr(), obj.data_ptr())
        mur_w_update.lagged_launches += 1
        return out, obj
    call("tpunmf_mur_w_update", x.device, x.data_ptr(), is_bf16,
         w.data_ptr(), h.data_ptr(), aux.data_ptr(), float(lam), m, n, k,
         int(is_kl), out.data_ptr())
    mur_w_update.launches += 1
    return out


@full_f32()
def mur_h_update(x, w, h, *, distance_type: str, lam: float):
    """One fused pass over X producing (updated H (k, n), raw numerator).

    The numerator is W^T X (EU) / W^T (X / (W H + eps)) (KL) with the
    *updated* W; for EU it feeds the Gram-trick objective."""
    is_kl = _check_distance(distance_type)
    if on_cpu(x):
        return mur_h_update_ref(x, w, h, distance_type=distance_type, lam=lam)
    check_operands("mur_h_update", x, w, h)
    aux = torch.sum(w, dim=0) if is_kl else w.T @ w
    m, n = x.shape
    k = w.shape[1]
    h_out = torch.empty((k, n), dtype=torch.float32, device=x.device)
    numer = torch.empty((k, n), dtype=torch.float32, device=x.device)
    call("tpunmf_mur_h_update", x.device, x.data_ptr(),
         int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr(),
         aux.data_ptr(), float(lam), m, n, k, int(is_kl), h_out.data_ptr(),
         numer.data_ptr())
    mur_h_update.launches += 1
    return h_out, numer


mur_w_update.launches = 0
mur_w_update.lagged_launches = 0
mur_h_update.launches = 0
