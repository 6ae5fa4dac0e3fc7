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

Both passes run their three products on the tensor cores in 3xTF32
(``csrc/tf32x3.cuh``: f32 accuracy, 165 TFLOP/s of f32 work on the H100
against 67 for FMA).  The W pass runs a grid of row tiles x 64-wide chunks
of k: a block walks all of n for its rows and applies the update itself
(:func:`w_block_rows` picks its rows; H is read at the row stride
:func:`h_stride`, through a zero-padded copy where n % 4 != 0, so that
every copy of H goes 16 bytes at a time).  The H pass runs a grid of
64-column tiles x row splits x 64-row chunks of k: each block adds its
range of X's rows into two partial sums in a scratch buffer, and a second
kernel adds the partials over the splits in a fixed order and applies the
update.  Both give the same bits on every call.  :func:`row_splits` picks
the number of splits from the shape alone.

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
# the H pass's tile: rows of X a step, columns of H a block, rows of k a chunk
H_TILE = 64
# an H100's SMs, and the blocks the H pass aims at: 16 a SM (2 resident, 8
# waves: 12 splits at MovieLens-10M ran 4% faster than 6)
_SMS = 132
_TARGET_BLOCKS = 16 * _SMS
# the most scratch the splits may take (two k x n f32 partial sums a split)
_MAX_SCRATCH_BYTES = 1 << 30


def masked_takes(x, k: int) -> bool:
    """Whether the masked kernels take X of this dtype at rank k: float32
    or bfloat16 X, 1 <= k <= 1024 (``tpunmf``'s ``masked_tileable`` gives
    no tile above 1024 either).  A solver asks this before it calls a
    wrapper; ``x`` is anything with ``.dtype`` (a ``meta`` tensor will do)."""
    return x.dtype in (torch.float32, torch.bfloat16) and 1 <= k <= MAX_RANK


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def row_splits(m: int, n: int, k: int) -> int:
    """The number of row splits of the H pass on X (m, n) at rank k.

    The grid is ceil(n / 64) column tiles x splits x ceil(k / 64) chunks;
    the splits bring it near 16 blocks a SM, at most one a 64-row tile of
    X and as many as 1 GiB of partial sums allow.  MovieLens-10M (69878 x
    10677, k 64): 167 column tiles x 13 splits = 2171 blocks."""
    tiles = _ceil_div(m, H_TILE)
    per_split = _ceil_div(n, H_TILE) * _ceil_div(k, H_TILE)
    want = round(_TARGET_BLOCKS / per_split)
    room = _MAX_SCRATCH_BYTES // (2 * k * n * 4)
    splits = max(1, min(want, tiles, room))
    # the splits that whole 64-row tiles give: none empty
    return _ceil_div(tiles, _ceil_div(tiles, splits))


def w_block_rows(m: int, k: int) -> int:
    """Rows of W (and of X) a block of the W pass owns: 64, or 32 where
    64-row blocks, ceil(m / 64) x ceil(k / 64) of them, would not fill one
    wave of the card (two blocks on each of its 132 SMs).  MovieLens-10M
    at k 64: 1092 blocks of 64 rows; MovieLens-1M (6040 rows): 189 of 32."""
    return 64 if _ceil_div(m, 64) * _ceil_div(k, H_TILE) >= 2 * _SMS else 32


def h_stride(n: int) -> int:
    """The row stride at which the W pass reads H (k, n): n rounded up to
    a multiple of 4 floats, so that every row starts on 16 bytes
    (MovieLens-10M: 10677 -> 10680)."""
    return _ceil_div(n, 4) * 4


def split_ranges(m: int, splits: int) -> list[tuple[int, int]]:
    """The rows [start, stop) of X that each split walks, as the kernel
    cuts them: ceil(tiles / splits) whole 64-row tiles a split, the last
    split short (or empty)."""
    per = _ceil_div(_ceil_div(m, H_TILE), splits) * H_TILE
    return [(min(m, s * per), min(m, (s + 1) * per)) for s in range(splits)]


def _guarded(num2, den, old):
    """where(den > 0, num2 / den, old): a cold row keeps its entries."""
    pos = den > 0
    return torch.where(pos, num2 / torch.where(pos, den, torch.ones_like(den)), old)


@full_f32()
def masked_w_parts(x, mask, w, h, *, distance_type: str):
    """The two (m, k) products of the masked W update: EU ((M*X) H^T,
    (M*(W H)) H^T), KL ((M*X / (W H + eps)) H^T, M H^T).  Over a mesh each
    is this rank's partial over its columns, summed before
    :func:`masked_w_closed`."""
    xf, mf = x.to(w.dtype), mask.to(w.dtype)
    wh = w @ h
    if distance_type == "eu":
        return (mf * xf) @ h.T, (mf * wh) @ h.T
    return (mf * xf / (wh + _EPS)) @ h.T, mf @ h.T


def masked_w_closed(w, num, den, *, distance_type: str, lam: float):
    """The masked W update from :func:`masked_w_parts`' products."""
    if distance_type == "eu":
        return w * num / (den + lam * w + _EPS)
    a = w * num
    return _guarded(2.0 * a, den + torch.sqrt(den * den + 4.0 * lam * a), w)


@full_f32()
def masked_h_parts(x, mask, w, h, *, distance_type: str):
    """The two (k, n) products of the masked H update, the mirror of
    :func:`masked_w_parts` (partials over a rank's rows on a mesh)."""
    xf, mf = x.to(h.dtype), mask.to(h.dtype)
    wh = w @ h
    if distance_type == "eu":
        return w.T @ (mf * xf), w.T @ (mf * wh)
    return w.T @ (mf * xf / (wh + _EPS)), w.T @ mf


def masked_h_closed(h, num, den, *, distance_type: str, lam: float):
    """The masked H update from :func:`masked_h_parts`' products."""
    if distance_type == "eu":
        return h * num / (den + lam * h + _EPS)
    c = h * num
    return _guarded(2.0 * c, den + torch.sqrt(den * den + 4.0 * lam * c), h)


@full_f32()
def masked_w_update_ref(x, mask, w, h, *, distance_type: str, lam: float):
    """Plain version of :func:`masked_w_update` (tpunmf/solvers/masked.py:79-108)."""
    num, den = masked_w_parts(x, mask, w, h, distance_type=distance_type)
    return masked_w_closed(w, num, den, distance_type=distance_type, lam=lam)


@full_f32()
def masked_h_update_ref(x, mask, w, h, *, distance_type: str, lam: float):
    """Plain version of :func:`masked_h_update`."""
    num, den = masked_h_parts(x, mask, w, h, distance_type=distance_type)
    return masked_h_closed(h, num, den, distance_type=distance_type, lam=lam)


def _run_kernel(name, x, mask, w, h, distance_type, lam, splits=None):
    """Check the operands and launch C entry ``tpunmf_<name>`` (the H pass
    over ``splits`` row splits, by default :func:`row_splits`')."""
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
    xmw = (x.data_ptr(), int(x.dtype == torch.bfloat16), mask.data_ptr(),
           int(mask.dtype in _BYTE_MASKS), w.data_ptr())
    kl = int(distance_type == "kl")
    if name == "masked_w_update":
        ldh = h_stride(n)
        hp = h if ldh == n else torch.nn.functional.pad(h, (0, ldh - n))
        out = torch.empty(w.shape, dtype=torch.float32, device=x.device)
        call("tpunmf_masked_w_update", x.device, *xmw, hp.data_ptr(), ldh, float(lam), m, n,
             k, kl, w_block_rows(m, k), out.data_ptr())
        return out
    splits = row_splits(m, n, k) if splits is None else int(splits)
    if splits < 1:
        raise ValueError(f"{name}: splits={splits} must be at least 1")
    part = torch.empty(2 * splits * k * n, dtype=torch.float32, device=x.device)
    out = torch.empty(h.shape, dtype=torch.float32, device=x.device)
    call("tpunmf_masked_h_update", x.device, *xmw, h.data_ptr(), float(lam), m, n, k, kl,
         part.data_ptr(), splits, out.data_ptr())
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
def masked_h_update(x, mask, w, h, *, distance_type: str, lam: float, splits=None):
    """One fused pass over (X, M) producing the masked-updated H (k, n),
    from the already-updated W (tpunmf/solvers/masked.py sequencing): two
    launches, the tensor-core pass over ``splits`` ranges of X's rows (by
    default :func:`row_splits`') and the fixed-order sum of its partials
    with the update.  The plain version has no splits."""
    if on_cpu(x):
        return masked_h_update_ref(x, mask, w, h, distance_type=distance_type,
                                   lam=lam)
    out = _run_kernel("masked_h_update", x, mask, w, h, distance_type, lam, splits)
    masked_h_update.launches += 1
    return out


masked_w_update.launches = 0
masked_h_update.launches = 0
