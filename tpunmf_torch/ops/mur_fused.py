"""The fused MUR iteration: the 2-pass pair, and the single pass.

  W pass (``mur_w_update``, csrc/mur_update.cu):
      EU: W <- W * (X H^T) / (W Gh + lw W + eps)               (nmf/mur.py:29)
      KL: a = W * ((X / (W H + eps)) H^T), b = rowsum(H),
          W <- 2a / (b + sqrt(b^2 + 4 lw a))                   (nmf/mur.py:25-27)
      KL with ``with_lagged_obj``: also the masked KL objective of the
          INCOMING (W, H), summed from the same W H tiles (the lagged
          objective, tpunmf/ops/mur_fused.py:114-141)
      Its products run on the tensor cores: EU as the single pass's W side
      (X H^T over column chunks into partials, in a scratch whose length
      the C entry's plan gives, then the update: the single pass's W' bit
      for bit), KL up to rank ``KL_W_TC_RANK`` as the masked W pass with
      M = 1 over ``splits`` ranges of X's columns (H read through a copy
      padded to ``masked_fused.h_stride(n)`` columns), above it an FMA
      body.
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
  iteration in one call; the caller finishes the k-sized H update.
  ``iter_eu_tileable`` / ``iter_kl_tileable`` are ``tpunmf``'s route rule
  for it.  ``mur_iteration_eu`` reads X once and takes its two products
  against it on the tensor cores; ``mur_iteration_kl`` runs the pair's KL
  bodies (the lagged W pass, then the H pass's numerator at the new W),
  each over all of X, so its outputs are theirs bit for bit, up to
  ``KL_ITER_PAIR_RANK`` and FMA waves of rows of X above it;
  ``mur_iteration_eu_dma`` is the EU pass with its copies overlapped with
  the products (``tpunmf``'s manual-DMA variant, which its
  ``mur_single_pass_variant`` switch selects; ``iter_eu_dma_tileable`` is
  its rule): on the card TMA copies feed ``wgmma`` products.

``updates_take`` says which X and ranks the kernels take (float32 or
bfloat16 X, k <= 1024); a solver asks it before it calls a wrapper.

Only the k x k Grams ``Gh = H H^T`` / ``Gw = W^T W``, the row/column sums
and the EU W passes' cast of H to X's dtype are formed outside the
kernels, as ``tpunmf`` forms them outside its Pallas bodies (and the KL W
pass's copy of H padded to 16-byte rows, and the "dma" variant's H split
in TF32 parts, ``_launch.eu_tma_operands``).  Outputs are
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
from ._launch import (MAX_RANK, WAVE_MUR_EU_TC, WAVE_MUR_KL, call, check_operands,
                      check_strips, eu_tma_operands, eu_tma_scratch, factor_as_x, on_cpu,
                      wave_scratch)
from .masked_fused import H_TILE, h_stride, row_splits

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
# the same line for the KL W pass (csrc/mur_update.cu, kKlWTcRank): on an
# H100 it won at k 320 and lost at k 384
KL_W_TC_RANK = 320
# the highest rank at which mur_iteration_kl runs the pair's bodies (W up
# to KL_W_TC_RANK on the tensor cores, H up to KL_H_TC_RANK); above it the
# pair's FMA bodies, with no splits, lose to the single pass's own FMA
# waves (on an H100 at 8192 x 1024 the pair's bodies won at k 448, 3.124
# against 3.197 ms, and lost at k 512, 3.744 against 3.626: PERF.md)
KL_ITER_PAIR_RANK = 448
# the KL W pass on the tensor cores: blocks of 64 rows of W
# (csrc/masked_update.cu, kKlWRows) and a 64-wide chunk of k over column
# splits of X, the grid brought near 16 blocks a SM of an H100's 132 (2
# resident, 8 waves).  On an H100 at BASELINE config[1] 64-row blocks over
# 7 splits took 1.73 ms, over 1 split 2.35 (tools/kernel_turns.py, PERF.md)
_KL_W_ROWS, _KL_W_BLOCKS = 64, 16 * 132


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


def kl_w_on_tensor_cores(k: int) -> bool:
    """Whether the KL W pass (plain and lagged) runs on the tensor cores at
    rank k, rather than its FMA body: up to ``KL_W_TC_RANK``."""
    return k <= KL_W_TC_RANK


def iteration_kl_on_pair(k: int) -> bool:
    """Whether ``mur_iteration_kl`` runs the 2-pass pair's KL bodies at
    rank k (up to ``KL_ITER_PAIR_RANK``), rather than its own FMA waves."""
    return k <= KL_ITER_PAIR_RANK


def w_splits(m: int, n: int, k: int) -> int:
    """The number of column splits of the KL W pass on X (m, n) at rank k,
    in whole 64-column tiles of X.

    The grid is ceil(m / 64) row tiles x ceil(k / 64) chunks of k x
    splits; the splits bring it near 16 blocks a SM, at most one a
    64-column tile of X and as many as 1 GiB of partial sums (an m x k f32
    sum a split) allow, none empty (BASELINE config[1], 20000 x 11000 r50:
    313 row tiles x 7 splits; 8192 x 4096 r128: 256 x 8).  1 where the
    pass takes its FMA body (k > ``KL_W_TC_RANK``)."""
    if not kl_w_on_tensor_cores(k):
        return 1
    tiles = _ceil_div(n, H_TILE)
    want = round(_KL_W_BLOCKS / (_ceil_div(m, _KL_W_ROWS) * _ceil_div(k, H_TILE)))
    room = _MAX_SCRATCH_BYTES // (m * k * 4)
    splits = max(1, min(want, tiles, room))
    return _ceil_div(tiles, _ceil_div(tiles, splits))


def w_scratch_floats(splits: int, m: int, k: int) -> int:
    """Floats of scratch the KL W pass needs over ``splits`` column
    splits: an m x k partial sum a split, none for one (the blocks apply
    the update themselves)."""
    return splits * m * k if splits > 1 else 0


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
                 with_lagged_obj: bool = False, splits=None):
    """One fused pass over X producing the updated W (m, k).

    With ``with_lagged_obj`` (KL only) returns ``(w_new, obj)``, obj the
    masked KL of the INCOMING (w, h) as a 0-d tensor: free, since the pass
    forms those W H tiles anyway.  The KL pass on the tensor cores sums
    over ``splits`` ranges of X's columns (by default :func:`w_splits`'),
    each into a partial sum, and adds the partials in a fixed order; EU,
    the FMA body and the plain version, which serves CPU tensors, have no
    splits."""
    is_kl = _check_distance(distance_type)
    _check_lagged(distance_type, with_lagged_obj)
    if on_cpu(x):
        return mur_w_update_ref(x, w, h, distance_type=distance_type, lam=lam,
                                with_lagged_obj=with_lagged_obj)
    m, n, k = check_operands("mur_w_update", x, w, h, max_rank=MAX_RANK)
    splits = w_splits(m, n, k) if splits is None else int(splits)
    if splits < 1:
        raise ValueError(f"mur_w_update: splits={splits} must be at least 1")
    is_bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if not is_kl:
        gh = h @ h.T
        hc = h.to(x.dtype)  # pre-cast, as mur_iteration_eu does
        floats = _build.library().tpunmf_mur_w_eu_scratch(m, n, k, x.element_size())
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
        call("tpunmf_mur_w_update", x.device, x.data_ptr(), is_bf16, w.data_ptr(),
             hc.data_ptr(), n, gh.data_ptr(), float(lam), m, n, k, 0, 1,
             scratch.data_ptr(), floats, out.data_ptr())
        mur_w_update.launches += 1
        return out
    hsum = torch.sum(h, dim=1)
    hp, ldh, splits, part, floats = _kl_w_operands(x, h, k, splits)
    args = (x.data_ptr(), is_bf16, w.data_ptr(), hp.data_ptr(), ldh, hsum.data_ptr(),
            float(lam), m, n, k)
    kl_args = (splits, part.data_ptr(), floats, out.data_ptr())
    if with_lagged_obj:
        partials = _lagged_partials(x, k, splits)
        obj = torch.empty((), dtype=torch.float32, device=x.device)
        call("tpunmf_mur_w_update_lagged", x.device, *args, *kl_args, partials.data_ptr(),
             obj.data_ptr())
        mur_w_update.lagged_launches += 1
        return out, obj
    call("tpunmf_mur_w_update", x.device, *args, 1, *kl_args)
    mur_w_update.launches += 1
    return out


def _kl_w_operands(x, h, k: int, splits: int):
    """The KL W pass's H and scratch: (H at its row stride, the stride,
    the splits, the partial sums' buffer, its length in floats).  On the
    tensor cores H goes through a copy padded to ``h_stride(n)`` columns
    where n % 4 != 0, over ``splits`` column splits; the FMA body takes H
    as it is and one split."""
    m, n = x.shape
    tensor_cores = kl_w_on_tensor_cores(k)
    splits = splits if tensor_cores else 1
    ldh = h_stride(n) if tensor_cores else n
    hp = h if ldh == n else torch.nn.functional.pad(h, (0, ldh - n))
    floats = w_scratch_floats(splits, m, k)
    part = torch.empty(max(floats, 1), dtype=torch.float32, device=x.device)
    return hp, ldh, splits, part, floats


def _lagged_partials(x, k: int, splits: int):
    """The lagged KL W pass's buffer of per-block objective partials."""
    count = _build.library().tpunmf_mur_w_lagged_blocks(x.shape[0], k, splits)
    return torch.empty(count, dtype=torch.float32, device=x.device)


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
    part = _h_partials(x, k, splits)
    call("tpunmf_mur_h_update", x.device, x.data_ptr(),
         int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr(),
         aux.data_ptr(), float(lam), m, n, k, int(is_kl), part.data_ptr(), splits,
         h_out.data_ptr(), numer.data_ptr())
    mur_h_update.launches += 1
    return h_out, numer


def _h_partials(x, k: int, splits: int):
    """The H pass's buffer of partial sums over ``splits`` row splits."""
    floats = h_scratch_floats(splits, x.shape[1], k)
    return torch.empty(max(floats, 1), dtype=torch.float32, device=x.device)


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


def _iteration_outputs(x, m: int, n: int, k: int):
    return tuple(torch.empty(shape, dtype=torch.float32, device=x.device)
                 for shape in ((m, k), (k, n), (k, k)))


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
    m, n, k = check_operands("mur_iteration_eu", x, w, h, max_rank=MAX_RANK)
    gh = h @ h.T
    hc = h.to(x.dtype)  # pre-cast, as tpunmf/ops/mur_fused.py:330
    out = _iteration_outputs(x, m, n, k)
    scratch = wave_scratch(x, k, WAVE_MUR_EU_TC)
    call("tpunmf_mur_iteration_eu", x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
         w.data_ptr(), hc.data_ptr(), gh.data_ptr(), float(lam_w), m, n, k,
         *(o.data_ptr() for o in out), scratch.data_ptr())
    mur_iteration_eu.launches += 1
    return out


@full_f32()
def mur_iteration_eu_dma(x, w, h, *, lam_w: float, bm: int):
    """The function of :func:`mur_iteration_eu` with its copies of X and
    the factors overlapped with the products (tpunmf/ops/mur_fused.py:
    465-512): on the card a producer warp keeps a ring of shared-memory
    stages filled by TMA while two warpgroups multiply with ``wgmma``
    (csrc/wave.cuh, TmaStages; 3xTF32 at f32 X, H split in TF32 parts by
    ``_launch.eu_tma_operands``).  Its stages and operands are those of
    ``mur_variants.v1_iter``, so at ``lam_w=0`` it gives v1's bits; against
    :func:`mur_iteration_eu`, whose products run on ``mma.sync``, it
    differs by the order of f32 sums.  ``bm`` is
    ``iter_eu_dma_tileable``'s strip height: it must divide m and give at
    least 2 strips, as in ``tpunmf``."""
    check_strips(x, bm)
    if x.shape[0] // bm < 2:
        raise ValueError("need at least 2 strips to double-buffer")
    if on_cpu(x):
        return mur_iteration_eu_dma_ref(x, w, h, lam_w=lam_w)
    m, n, k = check_operands("mur_iteration_eu_dma", x, w, h, max_rank=MAX_RANK)
    gh = h @ h.T
    f0, f1, ldh = eu_tma_operands(x, h)  # H pre-cast (tpunmf/ops/mur_fused.py:481) and split
    out = _iteration_outputs(x, m, n, k)
    scratch = eu_tma_scratch(x, k)
    call("tpunmf_mur_iteration_eu_dma", x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
         w.data_ptr(), f0.data_ptr(), f1.data_ptr(), ldh, gh.data_ptr(), float(lam_w), m, n, k,
         *(o.data_ptr() for o in out), scratch.data_ptr(), scratch.numel())
    mur_iteration_eu_dma.launches += 1
    return out


@full_f32()
def mur_iteration_kl(x, w, h, *, lam_w: float, bm: int, bs: int | None = None):
    """The KL W half-update, H numerator and lagged objective in one call.

    Returns (w_new (m, k), wtr = w_new^T (X / (w_new H + eps)) (k, n),
    obj 0-d), obj the masked KL of the INCOMING (w, h); the caller finishes
    with the H closed form (tpunmf/ops/mur_fused.py:652-702).  On the card,
    up to ``KL_ITER_PAIR_RANK``, it runs the 2-pass pair's KL bodies, each
    over all of X: the lagged W pass (so w_new and obj are
    ``mur_w_update(..., with_lagged_obj=True)``'s bit for bit) and then the
    H pass's numerator at w_new (so wtr is ``mur_h_update(x, w_new, h,
    distance_type="kl", lam=...)[1]``'s), with their default splits; above
    it, FMA waves of rows of X that fit the L2 (the same function, its sums
    in another order).  ``bm`` and ``bs`` must divide m and n, as in
    ``tpunmf``; ``bs`` chose a TPU tiling of the same function and changes
    nothing here."""
    check_strips(x, bm, bs)
    if on_cpu(x):
        return mur_iteration_kl_ref(x, w, h, lam_w=lam_w)
    m, n, k = check_operands("mur_iteration_kl", x, w, h, max_rank=MAX_RANK)
    hsum = torch.sum(h, dim=1)
    w_new = torch.empty((m, k), dtype=torch.float32, device=x.device)
    wtr = torch.empty((k, n), dtype=torch.float32, device=x.device)
    obj = torch.empty((), dtype=torch.float32, device=x.device)
    head = (x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr())
    outs = (w_new.data_ptr(), wtr.data_ptr(), obj.data_ptr())
    if iteration_kl_on_pair(k):
        hp, ldh, splits, w_part, w_floats = _kl_w_operands(x, h, k, w_splits(m, n, k))
        partials = _lagged_partials(x, k, splits)
        rows = h_splits(m, n, k, "kl")
        h_part = _h_partials(x, k, rows)
        call("tpunmf_mur_iteration_kl", x.device, *head, hp.data_ptr(), ldh,
             hsum.data_ptr(), float(lam_w), m, n, k, splits, w_part.data_ptr(), w_floats,
             partials.data_ptr(), rows, h_part.data_ptr(), h_scratch_floats(rows, n, k),
             *outs)
    else:
        scratch = wave_scratch(x, k, WAVE_MUR_KL)
        call("tpunmf_mur_iteration_kl_waves", x.device, *head, hsum.data_ptr(),
             float(lam_w), m, n, k, *outs, scratch.data_ptr())
    mur_iteration_kl.launches += 1
    return w_new, wtr, obj


mur_w_update.launches = 0
mur_w_update.lagged_launches = 0
mur_h_update.launches = 0
mur_iteration_eu.launches = 0
mur_iteration_eu_dma.launches = 0
mur_iteration_kl.launches = 0
