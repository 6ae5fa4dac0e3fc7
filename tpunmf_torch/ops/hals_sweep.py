"""HALS Gauss-Seidel sweeps: a CUDA kernel, with its plain version beside it.

``gs_sweep(a, g, v, lam=, nsweeps=)`` runs ``nsweeps`` sweeps of the k
dependent rank-1 closed forms over the rows of ``v`` (k, M), in
``tpunmf``'s transposed frame (tpunmf/ops/hals_sweep.py:232-274):

    for l in 0..k-1:
        numer   = a[l, :] - g[l, :] @ v + g[l, l] * v[l, :]
        v[l, :] = max(numer / (g[l, l] + lam + eps), 0)        eps = 1e-16

  W half: ``gs_sweep((X H^T)^T, H H^T, W^T)``;  H half: ``gs_sweep(W^T X,
  W^T W, H)`` (tpunmf/solvers/hals.py:125-150).

The kernel (csrc/hals_sweep.cu, its body csrc/gs_panel.cuh) keeps a tile
of 64 columns of ``v`` (32 or 16 above rank 256) in shared memory and
sweeps it in panels of 16 rows, each one tensor-core product against
``g`` and then a short chain of steps, one thread a column; it reads
``a``, ``v`` and the output through the strides of both axes, so the W
half's transposed views go in without a copy.  The
plain version (``gs_sweep_ref``) is the loop of ``tpunmf``'s
``_hals_sweep_h`` (the column form of ``_hals_sweep_w``), a few PyTorch
ops per step.  ``tpunmf``'s ``bm`` (strip width) and ``unrolled`` are
Mosaic tiling and trace-size knobs with no counterpart here.

The single-pass HALS iteration ``hals_iteration_eu(x, w, h, lam_w=,
nsweeps=, bm=)`` (csrc/hals_iteration.cu) is HALS's whole W half and the
H numerator from one read of X (tpunmf/ops/hals_sweep.py:120-229):

    xht = X round(H)^T,  W' = gs_sweep(xht^T, H H^T, W^T)^T,
    wtx = round(W')^T X,  gram_w = W'^T W'          (round: to X's dtype)

Its two products against X run on the tensor cores (``mur_iteration_eu``'s
stages, all of X in one wave), and the sweeps of every row (``gs_sweep``'s
body) run in one launch between them.

``hals_iter_tileable`` is ``tpunmf``'s rule for it; HALS takes it only
where the port's ``hals_single_pass`` switch is on (off, as in ``tpunmf``).

A wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.  ``gs_sweep.launches`` and
``hals_iteration_eu.launches`` count the launches.
"""
from __future__ import annotations

import torch

from ..core.precision import full_f32
from ._launch import (MAX_RANK, WAVE_HALS, call, check_operands, check_strips,
                      factor_as_x, on_cpu, wave_scratch)

_EPS = 1e-16  # tpunmf/ops/hals_sweep.py:38 (MUR's is 1e-9)
_INT_MAX = 2**31 - 1


def sweep_takes(x, k: int) -> bool:
    """Whether HALS on X of this dtype at rank k sweeps with the kernel:
    float32 X (``tpunmf`` engages its sweep kernel for float32 X only,
    tpunmf/solvers/hals.py:236-237; HALS's factors keep X's dtype) and
    1 <= k <= 1024.  ``x`` is anything with ``.dtype`` (a ``meta`` tensor
    will do)."""
    return x.dtype == torch.float32 and 1 <= k <= MAX_RANK


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


# ------------------------------------------- the single-pass HALS iteration

def hals_iter_tileable(x, k: int):
    """Strip height bm for the single-pass HALS iteration, or None.

    ``tpunmf``'s rule (tpunmf/ops/hals_sweep.py:162-183), copied as it is:
    float32 or bfloat16 X, k % 8 == 0 and k <= 256, within its budget.
    Its constants describe ``tpunmf``'s strip layout on the TPU (a
    full-width X strip, H^T, the WtX accumulator and the sweep state
    resident in its fast memory), not this card; the CUDA kernel chooses
    its own tiling.  ``x`` is anything with ``.shape`` and ``.dtype`` (a
    ``meta`` tensor will do)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        return None
    if k % 8 or k > 256:
        return None
    m, n = x.shape
    xb = x.dtype.itemsize
    budget = 13 * 1024 * 1024
    fixed = k * n * xb + k * n * 4 + 2 * k * k * 4
    for bm in (256, 128, 64, 32):
        if m % bm:
            continue
        need = fixed + 2 * bm * n * xb + 5 * bm * k * 4
        if need <= budget:
            return bm
    return None


@full_f32()
def hals_iteration_eu_ref(x, w, h, *, lam_w: float, nsweeps: int):
    """Plain version of :func:`hals_iteration_eu`: (w_new, wtx, gram_w)."""
    xf = x.to(w.dtype)
    xht = xf @ factor_as_x(h, x).T
    w_new = gs_sweep_ref(xht.T, h @ h.T, w.T, lam=lam_w, nsweeps=nsweeps).T
    wtx = factor_as_x(w_new, x).T @ xf
    return w_new, wtx, w_new.T @ w_new


@full_f32()
def hals_iteration_eu(x, w, h, *, lam_w: float, nsweeps: int, bm: int):
    """HALS's W half (``nsweeps`` sweeps against X round(H)^T and H H^T)
    and the H numerator in one pass over X.

    Returns (w_new (m, k), wtx = round(w_new)^T X (k, n), gram_w =
    w_new^T w_new (k, k)), all f32; the caller runs the H sweeps against
    (wtx, gram_w).  ``bm`` is ``hals_iter_tileable``'s strip height and
    must divide m, as in ``tpunmf``."""
    check_strips(x, bm)
    if on_cpu(x):
        return hals_iteration_eu_ref(x, w, h, lam_w=lam_w, nsweeps=nsweeps)
    m, n, k = check_operands("hals_iteration_eu", x, w, h, max_rank=MAX_RANK)
    hht = h @ h.T
    hc = h.to(x.dtype)  # pre-cast, as tpunmf/ops/hals_sweep.py:199
    w_new = torch.empty((m, k), dtype=torch.float32, device=x.device)
    wtx = torch.empty((k, n), dtype=torch.float32, device=x.device)
    gram = torch.empty((k, k), dtype=torch.float32, device=x.device)
    scratch = wave_scratch(x, k, WAVE_HALS)
    call("tpunmf_hals_iteration_eu", x.device, x.data_ptr(),
         int(x.dtype == torch.bfloat16), w.data_ptr(), hc.data_ptr(), hht.data_ptr(),
         float(lam_w), m, n, k, int(nsweeps), w_new.data_ptr(), wtx.data_ptr(),
         gram.data_ptr(), scratch.data_ptr(), scratch.numel())
    hals_iteration_eu.launches += 1
    return w_new, wtx, gram


gs_sweep.launches = 0
hals_iteration_eu.launches = 0
