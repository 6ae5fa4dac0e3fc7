"""Block maxima + relayout for the verified-exact serving top-k.

``serve/topk.py`` needs, per score row, the maxima of contiguous
``sel_block``-wide column blocks and the scores laid out as
(b, nbp, sel_block), so that its top blocks can be gathered whole
(tpunmf/ops/topk_select.py:1-19):

  * ``blockmax_relayout(scores)``: (b, n) scores -> (bmax (b, nbp),
    s3 (b, nbp, sel_block)), in the scores' dtype (float32, bfloat16,
    float64); where nbp * sel_block == n (n = 2^20 at the serving shape)
    s3 is a view of ``scores`` and shares its storage, and the kernel
    reads the scores once and writes only the maxima; kernel:
    csrc/topk_select.cu
  * ``score_blockmax_relayout(w_batch, h)``: the same pair for
    ``w_batch @ h`` with float32 accumulation and output whatever the
    inputs' dtype (float32, bfloat16, float16), without writing the b x n
    scores; kernel: csrc/topk_select.cu (TMA copies feeding ``wgmma``;
    W's operands from :func:`score_operands`)

nbp = ceil(n / (128 * sel_block)) * 128; the columns past n hold
``finfo(dtype).min`` (not -inf: a consumer may feed the blocks through
arithmetic where 0 * -inf would make NaN), and a NaN propagates into its
block's maximum.

A wrapper takes its plain version (``*_ref``) only for a tensor on the
CPU; for a CUDA tensor it launches its kernel or raises.  Each wrapper
counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from ..core.precision import full_f32
from ._launch import MAX_RANK, call, on_cpu, tf32_split

# blocks per output row are padded to a multiple of this (the TPU kernel's
# lane count; kept so that nbp and s3 have tpunmf's shapes)
_LANES = 128
_SCORE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_H_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _blocks(n: int, sel_block: int) -> int:
    if sel_block <= 0 or sel_block % 128:
        raise ValueError(f"sel_block {sel_block} must be a multiple of 128")
    return -(-n // (_LANES * sel_block)) * _LANES


def blockmax_relayout_ref(scores, sel_block: int = 128):
    """Plain version of :func:`blockmax_relayout` (``tpunmf``'s
    ``blockmax_relayout_jnp``); s3 may be a view of ``scores``."""
    b, n = scores.shape
    nbp = _blocks(n, sel_block)
    pad = nbp * sel_block - n
    if pad:
        fill = torch.full((b, pad), torch.finfo(scores.dtype).min,
                          dtype=scores.dtype, device=scores.device)
        scores = torch.cat([scores, fill], dim=1)
    s3 = scores.reshape(b, nbp, sel_block)
    return torch.amax(s3, dim=-1), s3


def blockmax_relayout(scores, sel_block: int = 128):
    """(b, n) scores -> (block maxima (b, nbp), relayout (b, nbp, sel_block)).

    Where nbp * sel_block == n, s3 is ``scores.view(b, nbp, sel_block)``
    (it shares the scores' storage, as the plain version's does) and the
    kernel writes only the maxima; elsewhere s3 is a fresh padded copy."""
    if on_cpu(scores):
        return blockmax_relayout_ref(scores, sel_block)
    if scores.dim() != 2:
        raise ValueError("blockmax_relayout: scores must be 2-D")
    if scores.dtype not in _SCORE_DTYPES:
        raise TypeError(f"blockmax_relayout: scores must be float32, bfloat16 or "
                        f"float64 on CUDA, got {scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("blockmax_relayout: scores must be contiguous")
    b, n = scores.shape
    nbp = _blocks(n, sel_block)
    bmax = torch.empty((b, nbp), dtype=scores.dtype, device=scores.device)
    if nbp * sel_block == n:
        s3, s3_ptr = scores.view(b, nbp, sel_block), None  # NULL: the kernel writes no s3
    else:
        s3 = torch.empty((b, nbp, sel_block), dtype=scores.dtype, device=scores.device)
        s3_ptr = s3.data_ptr()
    call("tpunmf_blockmax_relayout", scores.device, scores.data_ptr(),
         _SCORE_DTYPES[scores.dtype], b, n, nbp, sel_block, bmax.data_ptr(), s3_ptr)
    blockmax_relayout.launches += 1
    return bmax, s3


def score_blockmax_fits(b: int, r: int, h_itemsize: int, sel_block: int = 128) -> bool:
    """Whether :func:`score_blockmax_relayout`'s kernel takes this shape.

    ``tpunmf``'s check is a VMEM budget for a resident W tile and whole
    H strips.  The kernel here streams W and H through a ring of fixed
    shared-memory stages (128 columns of H by 64 users, 32 or 64 deep,
    whatever b, r and the dtype), so its only limits are the rank bound
    that every wrapper shares and a ``sel_block`` that is a multiple of its
    128-column tile.  Users past 64 take further tiles of the same columns
    of H, read while the first tile's are still in L2."""
    return 1 <= r <= MAX_RANK and sel_block > 0 and sel_block % 128 == 0


@full_f32()
def score_blockmax_relayout_ref(w_batch, h, sel_block: int = 128):
    """Plain version of :func:`score_blockmax_relayout`.  Both operands are
    upcast to float32 first: ``torch.matmul`` of bfloat16 tensors returns
    bfloat16, whose 8-bit mantissa ties scores at the selection threshold
    (tpunmf/serve/topk.py:319-326)."""
    scores = torch.matmul(w_batch.to(torch.float32), h.to(torch.float32))
    return blockmax_relayout_ref(scores, sel_block)


def score_operands(w_batch, h):
    """W's operands for the scoring kernel: (w0, w1, ldw, w16), (b, ldw)
    arrays with rows padded by zeros to 16 bytes.  Where W and H are both
    bfloat16 or both float16, w16 is True and w0 is W itself (w1 is w0):
    one 16-bit product.  Else w0 and w1 are the TF32 big and small parts
    of W in float32 (:func:`_launch.tf32_split`; exact for 16-bit W)."""
    r = w_batch.shape[1]
    w16 = w_batch.dtype == h.dtype and h.dtype in (torch.bfloat16, torch.float16)
    per = 8 if w16 else 4  # elements in 16 bytes
    ldw = -(-r // per) * per
    wp = torch.nn.functional.pad(w_batch if w16 else w_batch.to(torch.float32),
                                 (0, ldw - r)).contiguous()
    if w16:
        return wp, wp, ldw, True
    big, small = tf32_split(wp)
    return big, small, ldw, False


def score_blockmax_relayout(w_batch, h, sel_block: int = 128):
    """``w_batch @ h`` (float32 accumulation and output) and its block
    maxima and relayout, from one pass over H; the b x n scores are never
    written."""
    if on_cpu(h):
        return score_blockmax_relayout_ref(w_batch, h, sel_block)
    if w_batch.dim() != 2 or h.dim() != 2 or w_batch.shape[1] != h.shape[0]:
        raise ValueError(f"score_blockmax_relayout: shapes w{tuple(w_batch.shape)} "
                         f"h{tuple(h.shape)} do not chain")
    if h.dtype not in _H_DTYPES or w_batch.dtype not in _H_DTYPES:
        raise TypeError(f"score_blockmax_relayout: w and h must be float32, bfloat16 "
                        f"or float16 on CUDA, got {w_batch.dtype} and {h.dtype}")
    if w_batch.device != h.device:
        raise ValueError(f"score_blockmax_relayout: w on {w_batch.device}, h on {h.device}")
    if not h.is_contiguous():
        raise ValueError("score_blockmax_relayout: h must be contiguous")
    b, r = w_batch.shape
    n = h.shape[1]
    if not score_blockmax_fits(b, r, h.element_size(), sel_block):
        raise ValueError(f"score_blockmax_relayout: rank {r} or sel_block "
                         f"{sel_block} outside the kernel's range")
    nbp = _blocks(n, sel_block)
    w0, w1, ldw, w16 = score_operands(w_batch, h)
    bmax = torch.empty((b, nbp), dtype=torch.float32, device=h.device)
    s3 = torch.empty((b, nbp, sel_block), dtype=torch.float32, device=h.device)
    call("tpunmf_score_blockmax", h.device, w0.data_ptr(), w1.data_ptr(), ldw, h.data_ptr(),
         _H_DTYPES[h.dtype], int(w16), b, r, n, nbp, sel_block, bmax.data_ptr(),
         s3.data_ptr())
    score_blockmax_relayout.launches += 1
    return bmax, s3


blockmax_relayout.launches = 0
score_blockmax_relayout.launches = 0
