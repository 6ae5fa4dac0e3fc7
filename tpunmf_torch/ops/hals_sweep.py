"""HALS Gauss-Seidel sweeps: a CUDA kernel, with its plain version beside it.

``gs_sweep(a, g, v, lam=, nsweeps=)`` runs ``nsweeps`` sweeps of the k
dependent rank-1 closed forms over the rows of ``v`` (k, M), in
``tpunmf``'s transposed frame (tpunmf/ops/hals_sweep.py:232-274):

    for l in 0..k-1:
        numer   = a[l, :] - g[l, :] @ v + g[l, l] * v[l, :]
        v[l, :] = max(numer / (g[l, l] + lam + eps), 0)        eps = 1e-16

  W half: ``gs_sweep((X H^T)^T, H H^T, W^T)``;  H half: ``gs_sweep(W^T X,
  W^T W, H)`` (tpunmf/solvers/hals.py:125-150).

The kernel (csrc/hals_sweep.cu) gives each column of the M axis a warp
of its own and reads ``a``, ``v`` and the output through the strides of
both axes, so the W half's transposed views go in without a copy.  The
plain version (``gs_sweep_ref``) is the loop of ``tpunmf``'s
``_hals_sweep_h`` (the column form of ``_hals_sweep_w``), a few PyTorch
ops per step.  ``tpunmf``'s ``bm`` (strip width) and ``unrolled`` are
Mosaic tiling and trace-size knobs with no counterpart here.

A wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.  ``gs_sweep.launches``
counts the launches.
"""
from __future__ import annotations

import torch

from ..core.precision import full_f32
from ._launch import MAX_RANK, call, on_cpu

_EPS = 1e-16  # tpunmf/ops/hals_sweep.py:38 (MUR's is 1e-9)
_INT_MAX = 2**31 - 1


@full_f32()
def gs_sweep_ref(a, g, v, *, lam: float, nsweeps: int):
    """Plain version of :func:`gs_sweep`; returns a new tensor laid out as
    ``v`` (so the W half's ``.T`` of the result is row-major again)."""
    v = v.clone()
    for _ in range(nsweeps):
        for l in range(v.shape[0]):
            gll = g[l, l]
            numer = a[l, :] - g[l, :] @ v + gll * v[l, :]
            v[l, :] = torch.clamp(numer / (gll + lam + _EPS), min=0.0)
    return v


def _check(a, g, v):
    if a.dim() != 2 or g.dim() != 2 or v.dim() != 2:
        raise ValueError("gs_sweep: a, g and v must be 2-D")
    k, cols = v.shape
    if a.shape != (k, cols) or g.shape != (k, k):
        raise ValueError(f"gs_sweep: shapes a{tuple(a.shape)} g{tuple(g.shape)} "
                         f"v{tuple(v.shape)} do not match")
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"gs_sweep: rank k={k} outside [1, {MAX_RANK}]")
    for t in (a, g, v):
        if t.device != v.device:
            raise ValueError(f"gs_sweep: operands on {t.device} and {v.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gs_sweep: operands must be float32 on CUDA, got "
                            f"{t.dtype} (pass use_pallas=False for the plain route)")
        if max(t.stride()) > _INT_MAX:
            raise ValueError("gs_sweep: strides above 2^31 - 1")
    if not g.is_contiguous():
        raise ValueError("gs_sweep: g must be contiguous")
    return k, cols


@full_f32()
def gs_sweep(a, g, v, *, lam: float, nsweeps: int):
    """``nsweeps`` HALS Gauss-Seidel sweeps over the rows of ``v``.

    a, v: (k, M) transposed-frame numerator and factor, any strides;
    g: (k, k) Gram.  Returns the updated (k, M) factor, laid out as ``v``.
    """
    if on_cpu(v):
        return gs_sweep_ref(a, g, v, lam=lam, nsweeps=nsweeps)
    k, cols = _check(a, g, v)
    out = torch.empty_like(v)  # v's strides, for a dense v
    call("tpunmf_gs_sweep", v.device, a.data_ptr(), *a.stride(), g.data_ptr(),
         v.data_ptr(), *v.stride(), float(lam), k, cols, int(nsweeps),
         out.data_ptr(), *out.stride())
    gs_sweep.launches += 1
    return out


gs_sweep.launches = 0
