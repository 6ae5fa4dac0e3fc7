"""The sweep scripts' single-pass EU variants (csrc/mur_variants.cu).

``tpunmf``'s sweep experiments (benchmarks/sweep_iter2.py,
benchmarks/sweep_int8.py) try three operand variants of the MUR EU single
pass at lam_w = 0:

  ``v1_iter``: H^T pre-cast to X's dtype outside the kernel
      W' = W * (X ht) / (W Gh + eps), wtx = round(W')^T X, gw = W'^T W'
  ``v2_iter``: v1, then H' = H * wtx / (gw H + eps) after the last strip;
      returns (W', H', wtx, gw)
  ``iter_eu_int8``: v1 on int8 X with a per-matrix scale s, multiplied in
      bf16: numer = s (bf16(Xq) bf16(H)^T), wtx = s (bf16(W')^T bf16(Xq))

(round: to X's dtype.)  Gh = H H^T and the transposed ht are formed in
torch outside the kernels, as the scripts form them outside their Pallas
bodies (sweep_iter2.py:41-42).  On the card all three run the stages of
``mur_fused.mur_iteration_eu_dma`` (TMA copies feeding ``wgmma``): ht is
made into that pass's (k, n) factor operands (``_launch.eu_tma_operands``,
the same arrays the dma variant makes from H), so v1 is the dma variant at
lam_w = 0 bit for bit; int8 takes H in bf16 the same way and widens X to
bf16 in registers, so at scale 1 it is v1 on ``xq.to(torch.bfloat16)``
bit for bit.  ``bm`` is the scripts' strip height and must
divide m: their grids ``m // bm`` silently drop the last m % bm rows,
where these wrappers raise.  The kernels choose their own tiling.

A wrapper takes its plain version (``*_ref``) only for a tensor on the
CPU; for a CUDA tensor it launches its kernel or raises.  Each wrapper
counts its launches in ``<wrapper>.launches``.  The plain versions round
the same operands as the kernels.
"""
from __future__ import annotations

import torch

from ..core.precision import full_f32
from ._launch import (MAX_RANK, call, check_operands, check_strips, eu_tma_operands,
                      eu_tma_scratch, factor_as_x, on_cpu)

_EPS = 1e-9
_X_DTYPES = (torch.float32, torch.bfloat16)


def _check_dtypes(name, x, w, h, x_dtypes):
    """The dtypes the scripts' kernels take, on any device (their outputs
    are hard-coded f32, and float64 X fails inside them)."""
    if x.dtype not in x_dtypes:
        raise TypeError(f"{name}: x must be {' or '.join(map(str, x_dtypes))}, got {x.dtype}")
    if w.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"{name}: factors must be float32, got {w.dtype} and {h.dtype}")


@full_f32()
def v1_iter_ref(x, w, h):
    """Plain version of :func:`v1_iter`: (w_new, wtx, gw)."""
    xf = x.to(w.dtype)
    numer = xf @ factor_as_x(h, x).T
    w_new = w * numer / (w @ (h @ h.T) + _EPS)
    wtx = factor_as_x(w_new, x).T @ xf
    return w_new, wtx, w_new.T @ w_new


@full_f32()
def v2_iter_ref(x, w, h):
    """Plain version of :func:`v2_iter`: (w_new, h_new, wtx, gw)."""
    w_new, wtx, gw = v1_iter_ref(x, w, h)
    return w_new, h * wtx / (gw @ h + _EPS), wtx, gw


@full_f32()
def iter_eu_int8_ref(xq, scale, w, h):
    """Plain version of :func:`iter_eu_int8`: (w_new, wtx, gw)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=xq.device)
    xb = xq.to(torch.bfloat16).float()  # exact: |xq| <= 127
    numer = (xb @ h.to(torch.bfloat16).float().T) * s
    w_new = w * numer / (w @ (h @ h.T) + _EPS)
    wtx = w_new.to(torch.bfloat16).float().T @ xb
    return w_new, wtx * s, w_new.T @ w_new


def v_operands(x, h):
    """v1's and v2's H operands: H^T pre-cast to X's dtype and laid out (n,
    k), as sweep_iter2.py:42 makes it, then made into the (k, n) factor
    operands of the pass on TMA and wgmma (``_launch.eu_tma_operands``):
    the same arrays as ``mur_iteration_eu_dma`` makes from H."""
    ht = h.T.to(x.dtype).contiguous()
    return eu_tma_operands(x, ht.T)


def _launch_v(name, x, w, h, with_h):
    m, n, k = check_operands(name, x, w, h, max_rank=MAX_RANK)
    gh = h @ h.T
    f0, f1, ldh = v_operands(x, h)
    w_new = torch.empty((m, k), dtype=torch.float32, device=x.device)
    wtx = torch.empty((k, n), dtype=torch.float32, device=x.device)
    gw = torch.empty((k, k), dtype=torch.float32, device=x.device)
    scratch = eu_tma_scratch(x, k)
    head = (x.data_ptr(), int(x.dtype == torch.bfloat16), f0.data_ptr(), f1.data_ptr(), ldh)
    tail = (scratch.data_ptr(), scratch.numel())
    if not with_h:
        call("tpunmf_v1_iter", x.device, *head, w.data_ptr(), gh.data_ptr(), m, n, k,
             w_new.data_ptr(), wtx.data_ptr(), gw.data_ptr(), *tail)
        return w_new, wtx, gw
    h_new = torch.empty((k, n), dtype=torch.float32, device=x.device)
    call("tpunmf_v2_iter", x.device, *head, h.data_ptr(), w.data_ptr(), gh.data_ptr(), m, n, k,
         w_new.data_ptr(), h_new.data_ptr(), wtx.data_ptr(), gw.data_ptr(), *tail)
    return w_new, h_new, wtx, gw


@full_f32()
def v1_iter(x, w, h, bm):
    """One EU single pass at lam_w = 0 with H^T pre-cast to X's dtype
    (benchmarks/sweep_iter2.py:38-62): (w_new (m, k), wtx = round(w_new)^T X
    (k, n), gw = w_new^T w_new (k, k)), all f32.  The same function, and on
    the card the same bits, as ``mur_fused.mur_iteration_eu_dma(lam_w=0)``."""
    check_strips(x, bm)
    _check_dtypes("v1_iter", x, w, h, _X_DTYPES)
    if on_cpu(x):
        return v1_iter_ref(x, w, h)
    out = _launch_v("v1_iter", x, w, h, with_h=False)
    v1_iter.launches += 1
    return out


@full_f32()
def v2_iter(x, w, h, bm):
    """:func:`v1_iter` with the H update folded in
    (benchmarks/sweep_iter2.py:92-120): (w_new, h_new = h * wtx / (gw h +
    eps), wtx, gw).  On the card the H update is one more launch after the
    pass, in stream order, where the TPU kernel runs it in its last grid step."""
    check_strips(x, bm)
    _check_dtypes("v2_iter", x, w, h, _X_DTYPES)
    if on_cpu(x):
        return v2_iter_ref(x, w, h)
    out = _launch_v("v2_iter", x, w, h, with_h=True)
    v2_iter.launches += 1
    return out


@full_f32()
def iter_eu_int8(xq, scale, w, h, bm):
    """One EU single pass at lam_w = 0 on int8 X with the per-matrix scale
    ``scale`` (X ~ scale * xq; benchmarks/sweep_int8.py:49-75): (w_new,
    wtx = scale * bf16(w_new)^T xq, gw), all f32.  ``scale`` is a 0-d (or
    one-element) float32 tensor or a number; the kernel reads it from
    device memory."""
    check_strips(xq, bm)
    _check_dtypes("iter_eu_int8", xq, w, h, (torch.int8,))
    if on_cpu(xq):
        return iter_eu_int8_ref(xq, scale, w, h)
    m, n, k = check_operands("iter_eu_int8", xq, w, h, max_rank=MAX_RANK,
                             x_dtypes=(torch.int8,))
    s = torch.as_tensor(scale, dtype=torch.float32, device=xq.device).reshape(())
    gh = h @ h.T
    hb, _, ldh = eu_tma_operands(xq, h)
    w_new = torch.empty((m, k), dtype=torch.float32, device=xq.device)
    wtx = torch.empty((k, n), dtype=torch.float32, device=xq.device)
    gw = torch.empty((k, k), dtype=torch.float32, device=xq.device)
    scratch = eu_tma_scratch(xq, k)
    call("tpunmf_iter_eu_int8", xq.device, xq.data_ptr(), hb.data_ptr(), ldh, w.data_ptr(),
         gh.data_ptr(), s.data_ptr(), m, n, k, w_new.data_ptr(), wtx.data_ptr(),
         gw.data_ptr(), scratch.data_ptr(), scratch.numel())
    iter_eu_int8.launches += 1
    return w_new, wtx, gw


v1_iter.launches = 0
v2_iter.launches = 0
iter_eu_int8.launches = 0
