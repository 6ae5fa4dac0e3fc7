"""The fused MUR iteration: the 2-pass pair, and the single pass.

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
      Its products run on the tensor cores (3xTF32 ``mma.sync``) over
      ``splits`` ranges of X's rows, each into a partial sum that a second
      kernel adds in a fixed order (:func:`h_splits` picks the count from
      the shape alone); the KL pass above rank ``KL_H_TC_RANK`` runs an FMA
      body over all rows instead.

  Single pass (``mur_iteration_eu`` / ``mur_iteration_kl``,
  csrc/mur_iteration.cu): the W update and the H numerator of a whole
  iteration from one read of X in device memory; the caller finishes the
  k-sized H update.  ``iter_eu_tileable`` / ``iter_kl_tileable`` are
  ``tpunmf``'s route rule for it.  ``mur_iteration_eu`` takes its two
  products against X on the tensor cores; ``mur_iteration_eu_dma`` is the
  EU pass on FMA tiles with its copies overlapped with the products
  (``tpunmf``'s manual-DMA variant, which its ``mur_single_pass_variant``
  switch selects; ``iter_eu_dma_tileable`` is its rule).

``updates_take`` says which X and ranks the kernels take (float32 or
bfloat16 X, k <= 1024); a solver asks it before it calls a wrapper.

Only the k x k Grams ``Gh = H H^T`` / ``Gw = W^T W``, the row/column sums
and the single pass's cast of H to X's dtype are formed outside the
kernels, as ``tpunmf`` forms them outside its Pallas bodies.  Outputs are
new tensors: nothing is updated in place (the EU epilogue of a row block
reads all of W_i).

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
from ._launch import (MAX_RANK, WAVE_MUR_EU, WAVE_MUR_EU_TC, WAVE_MUR_KL, call,
                      check_operands, check_strips, factor_as_x, on_cpu, wave_scratch)
from .masked_fused import H_TILE, row_splits

_EPS = 1e-9
_X_DTYPES = (torch.float32, torch.bfloat16)
# The EU H pass's blocks (csrc/mur_update.cu): 128 x 128 tiles of (k, n),
# two resident an SM; its row splits bring the grid near 4 a SM of an
# H100's 132, within 1 GiB of partial sums (a k x n f32 sum a split).
_EU_H_TILE, _EU_H_BLOCKS = 128, 4 * 132
_MAX_SCRATCH_BYTES = 1 << 30
# the highest rank at which the KL H pass runs on the tensor cores: each
# 64-row chunk of k forms W H anew there, and above it the FMA body, which
# forms it once, is faster (csrc/mur_update.cu, kKlTcRank)
KL_H_TC_RANK = 640


def updates_take(x, k: int) -> bool:
    """Whether this module's kernels (the 2-pass pair and the single pass)
    take X of this dtype at rank k: float32 or bfloat16 X, 1 <= k <= 1024.
    A solver asks this before it calls a wrapper; the wrappers raise on
    what they refuse.  ``x`` is anything with ``.dtype`` (a ``meta``
    tensor will do)."""
    return x.dtype in _X_DTYPES and 1 <= k <= MAX_RANK


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def h_splits(m: int, n: int, k: int, distance_type: str) -> int:
    """The number of row splits of the H pass on X (m, n) at rank k, in
    whole 64-row tiles of X (``masked_fused.split_ranges`` cuts them).

    KL: the masked H pass's kernel with M = 1, so its count,
    ``masked_fused.row_splits`` (BASELINE config[1], 20000 x 11000 r50:
    172 column tiles x 12 splits), or 1 where the pass takes its FMA body
    (k > ``KL_H_TC_RANK``).  EU: a grid of ceil(n / 128) x ceil(k / 128)
    tiles x splits brought near 4 blocks a SM (8192 x 8192 r128: 64 tiles
    x 8 splits), at most one split a tile of X and as many as 1 GiB of
    partial sums allow, none empty."""
    if distance_type == "kl":
        return 1 if k > KL_H_TC_RANK else row_splits(m, n, k)
    tiles = _ceil_div(m, H_TILE)
    want = round(_EU_H_BLOCKS / (_ceil_div(n, _EU_H_TILE) * _ceil_div(k, _EU_H_TILE)))
    room = _MAX_SCRATCH_BYTES // (k * n * 4)
    splits = max(1, min(want, tiles, room))
    return _ceil_div(tiles, _ceil_div(tiles, splits))


def h_scratch_floats(splits: int, n: int, k: int) -> int:
    """Floats of scratch the H pass needs over ``splits`` row splits: a
    k x n partial sum a split, none for one (it sums into its output)."""
    return splits * k * n if splits > 1 else 0


@full_f32()
def mur_w_update_ref(x, w, h, *, distance_type: str, lam: float,
                     with_lagged_obj: bool = False):
    """Plain version of :func:`mur_w_update`."""
    _check_lagged(distance_type, with_lagged_obj)
    xf = x.to(w.dtype)
    if distance_type == "eu":
        gh = h @ h.T
        numer = xf @ factor_as_x(h, x).T
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
        numer = factor_as_x(w, x).T @ xf
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
    check_operands("mur_w_update", x, w, h, max_rank=MAX_RANK)
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
def mur_h_update(x, w, h, *, distance_type: str, lam: float, splits=None):
    """One fused pass over X producing (updated H (k, n), raw numerator).

    The numerator is W^T X (EU) / W^T (X / (W H + eps)) (KL) with the
    *updated* W; for EU it feeds the Gram-trick objective.  The kernel
    sums over ``splits`` ranges of X's rows (by default
    :func:`h_splits`'), each into a partial sum, and adds the partials in
    a fixed order; the plain version, which serves CPU tensors, has no
    splits."""
    is_kl = _check_distance(distance_type)
    if on_cpu(x):
        return mur_h_update_ref(x, w, h, distance_type=distance_type, lam=lam)
    m, n, k = check_operands("mur_h_update", x, w, h, max_rank=MAX_RANK)
    splits = h_splits(m, n, k, distance_type) if splits is None else int(splits)
    if splits < 1:
        raise ValueError(f"mur_h_update: splits={splits} must be at least 1")
    aux = torch.sum(w, dim=0) if is_kl else w.T @ w
    h_out = torch.empty((k, n), dtype=torch.float32, device=x.device)
    numer = torch.empty((k, n), dtype=torch.float32, device=x.device)
    part = torch.empty(max(h_scratch_floats(splits, n, k), 1), dtype=torch.float32,
                       device=x.device)
    call("tpunmf_mur_h_update", x.device, x.data_ptr(),
         int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr(),
         aux.data_ptr(), float(lam), m, n, k, int(is_kl), part.data_ptr(), splits,
         h_out.data_ptr(), numer.data_ptr())
    mur_h_update.launches += 1
    return h_out, numer


# ------------------------------------------------- the single-pass iteration

def iter_eu_tileable(x, k: int):
    """Strip height bm for the single-pass EU iteration, or None.

    This is ``tpunmf``'s route rule (tpunmf/ops/mur_fused.py:290-311),
    kept so that each shape takes the route ``tpunmf`` gives it: its
    constants describe ``tpunmf``'s strip layout on the TPU (a full-width X
    strip, H^T and the WtX accumulator resident in its fast memory), not
    this card.  The CUDA kernel chooses its own tiling; ``bm`` is checked
    against m, as ``tpunmf`` checks it.  ``x`` is anything with ``.shape``
    and ``.dtype`` (a ``meta`` tensor will do)."""
    if x.dtype not in _X_DTYPES:
        return None
    m, n = x.shape
    xb = x.dtype.itemsize
    budget = 14 * 1024 * 1024
    fixed = k * n * xb + k * n * 4 + k * k * 4 * 2
    cands = (512, 256, 128, 64, 32, 16) if xb == 2 else \
            (512, 256, 128, 64, 32, 16, 8)
    for bm in cands:
        if m % bm:
            continue
        need = fixed + 2 * bm * n * xb + 3 * bm * k * 4
        if need <= budget:
            return bm
    return None


def iter_kl_tileable(x, k: int):
    """(bm, bs) for the single-pass KL iteration, or None.

    ``tpunmf``'s route rule (tpunmf/ops/mur_fused.py:563-592), kept so
    that each shape takes the route ``tpunmf`` gives it; its constants
    describe ``tpunmf``'s resident strip on the TPU, not this card.  It
    never selects the column-subblocked variant (bs is always None)."""
    if x.dtype not in _X_DTYPES:
        return None
    m, n = x.shape
    xb = x.dtype.itemsize
    budget = 14 * 1024 * 1024
    fixed = 2 * k * n * 4
    for bm in (128, 64):
        if m % bm:
            continue
        need = fixed + 2 * bm * n * xb + 2 * bm * n * 4 + 3 * bm * k * 4
        if need <= budget:
            return bm, None
    return None


def iter_eu_dma_tileable(x, k: int):
    """Strip height bm for the "dma" variant of the single-pass EU
    iteration, or None.

    ``tpunmf``'s route rule (tpunmf/ops/mur_fused.py:445-462), copied as
    it is: its constants describe the manual-DMA kernel's residency in the
    TPU's fast memory (H^T, the WtX accumulator, two X strip slots, the W
    slots), not this card.  It needs at least 2 strips.  ``x`` is anything
    with ``.shape`` and ``.dtype`` (a ``meta`` tensor will do)."""
    if x.dtype not in _X_DTYPES:
        return None
    m, n = x.shape
    xb = x.dtype.itemsize
    budget = 13 * 1024 * 1024
    fixed = k * n * xb + k * n * 4 + 2 * k * k * 4
    for bm in (256, 128, 64, 32):
        if m % bm or m // bm < 2:
            continue
        need = fixed + 2 * bm * n * xb + 4 * bm * k * 4
        if need <= budget:
            return bm
    return None


@full_f32()
def mur_iteration_eu_ref(x, w, h, *, lam_w: float):
    """Plain version of :func:`mur_iteration_eu`: (w_new, wtx, gram_w)."""
    xf = x.to(w.dtype)
    numer = xf @ factor_as_x(h, x).T
    w_new = w * numer / (w @ (h @ h.T) + lam_w * w + _EPS)
    wtx = factor_as_x(w_new, x).T @ xf
    return w_new, wtx, w_new.T @ w_new


@full_f32()
def mur_iteration_kl_ref(x, w, h, *, lam_w: float):
    """Plain version of :func:`mur_iteration_kl`: (w_new, wtr, obj)."""
    xf = x.to(w.dtype)
    wh = w @ h
    a = w * ((xf / (wh + _EPS)) @ h.T)
    b = torch.sum(h, dim=1)[None, :]
    w_new = 2.0 * a / (b + torch.sqrt(b * b + 4.0 * lam_w * a))
    wtr = w_new.T @ (xf / (w_new @ h + _EPS))
    return w_new, wtr, kl_elementwise_sum(xf, wh)


@full_f32()
def mur_iteration_eu_dma_ref(x, w, h, *, lam_w: float):
    """Plain version of :func:`mur_iteration_eu_dma`: the function of
    :func:`mur_iteration_eu_ref` (tpunmf names ``mur_iteration_eu`` as the
    DMA kernel's CPU oracle, tpunmf/ops/mur_fused.py:470-472)."""
    return mur_iteration_eu_ref(x, w, h, lam_w=lam_w)


def _launch_iteration_eu(name, x, w, h, lam_w, dma):
    m, n, k = check_operands(name, x, w, h, max_rank=MAX_RANK)
    gh = h @ h.T
    hc = h.to(x.dtype)  # pre-cast, as tpunmf/ops/mur_fused.py:330, :481
    w_new = torch.empty((m, k), dtype=torch.float32, device=x.device)
    wtx = torch.empty((k, n), dtype=torch.float32, device=x.device)
    gram = torch.empty((k, k), dtype=torch.float32, device=x.device)
    scratch = wave_scratch(x, k, WAVE_MUR_EU if dma else WAVE_MUR_EU_TC)
    call("tpunmf_mur_iteration_eu", x.device, x.data_ptr(),
         int(x.dtype == torch.bfloat16), w.data_ptr(), hc.data_ptr(), gh.data_ptr(),
         float(lam_w), m, n, k, w_new.data_ptr(), wtx.data_ptr(), gram.data_ptr(),
         scratch.data_ptr(), int(dma))
    return w_new, wtx, gram


@full_f32()
def mur_iteration_eu(x, w, h, *, lam_w: float, bm: int):
    """The EU W half-update and H numerator in one pass over X.

    Returns (w_new (m, k), wtx = round(w_new)^T X (k, n), gram_w =
    w_new^T w_new (k, k)), all f32; the caller finishes with
    ``h * wtx / (gram_w @ h + lam_h h + eps)`` (tpunmf/ops/mur_fused.py:
    314-362).  Its two products against X run on the tensor cores.
    ``bm`` is ``iter_eu_tileable``'s strip height and must divide m, as in
    ``tpunmf``."""
    check_strips(x, bm)
    if on_cpu(x):
        return mur_iteration_eu_ref(x, w, h, lam_w=lam_w)
    out = _launch_iteration_eu("mur_iteration_eu", x, w, h, lam_w, dma=False)
    mur_iteration_eu.launches += 1
    return out


@full_f32()
def mur_iteration_eu_dma(x, w, h, *, lam_w: float, bm: int):
    """The function of :func:`mur_iteration_eu` on FMA tiles, with its
    copies of X and the factors overlapped with the products
    (tpunmf/ops/mur_fused.py:465-512): the kernel stages each slab in two
    shared-memory buffers with ``cp.async``.  At ``lam_w=0`` its FMAs and
    their order are those of ``mur_variants.v1_iter``, so it gives v1's
    bits; against :func:`mur_iteration_eu`, whose products run on the
    tensor cores, it differs by the order of f32 sums.  ``bm`` is
    ``iter_eu_dma_tileable``'s strip height: it must divide m and give at
    least 2 strips, as in ``tpunmf``."""
    check_strips(x, bm)
    if x.shape[0] // bm < 2:
        raise ValueError("need at least 2 strips to double-buffer")
    if on_cpu(x):
        return mur_iteration_eu_dma_ref(x, w, h, lam_w=lam_w)
    out = _launch_iteration_eu("mur_iteration_eu_dma", x, w, h, lam_w, dma=True)
    mur_iteration_eu_dma.launches += 1
    return out


@full_f32()
def mur_iteration_kl(x, w, h, *, lam_w: float, bm: int, bs: int | None = None):
    """The KL W half-update, H numerator and lagged objective in one pass.

    Returns (w_new (m, k), wtr = w_new^T (X / (w_new H + eps)) (k, n),
    obj 0-d), obj the masked KL of the INCOMING (w, h); the caller finishes
    with the H closed form (tpunmf/ops/mur_fused.py:652-702).  ``bm`` and
    ``bs`` must divide m and n, as in ``tpunmf``; ``bs`` chose a TPU
    tiling of the same function and changes nothing here."""
    check_strips(x, bm, bs)
    if on_cpu(x):
        return mur_iteration_kl_ref(x, w, h, lam_w=lam_w)
    m, n, k = check_operands("mur_iteration_kl", x, w, h, max_rank=MAX_RANK)
    hsum = torch.sum(h, dim=1)
    w_new = torch.empty((m, k), dtype=torch.float32, device=x.device)
    wtr = torch.empty((k, n), dtype=torch.float32, device=x.device)
    obj = torch.empty((), dtype=torch.float32, device=x.device)
    scratch = wave_scratch(x, k, WAVE_MUR_KL)
    call("tpunmf_mur_iteration_kl", x.device, x.data_ptr(),
         int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr(), hsum.data_ptr(),
         float(lam_w), m, n, k, w_new.data_ptr(), wtr.data_ptr(), obj.data_ptr(),
         scratch.data_ptr())
    mur_iteration_kl.launches += 1
    return w_new, wtr, obj


mur_w_update.launches = 0
mur_w_update.lagged_launches = 0
mur_h_update.launches = 0
mur_iteration_eu.launches = 0
mur_iteration_eu_dma.launches = 0
mur_iteration_kl.launches = 0
