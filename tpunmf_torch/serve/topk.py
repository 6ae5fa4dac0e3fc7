"""Serving path: W @ H scoring + exact top-k retrieval on one device.

Same contract as ``tpunmf.serve.topk`` (tpunmf/serve/topk.py:33-343,
434-502, 530-642): a batch of user rows of W is scored against every item
column of H and the top k items are returned, exactly, in ``lax.top_k``'s
order: value descending, then the lowest index first, NaN first.  Indices
are int64 (torch's index type; ``tpunmf`` returns int32).

Over a wide item axis the top-k takes ``tpunmf``'s block-max route
(:func:`_exact_topk`): the block maxima and the (b, nbp, 128) relayout come
from the kernels of ``ops/topk_select.py`` (fused behind the scoring
product by default, or after a ``torch.matmul``), the top blocks are
gathered and the small candidate set sorted, and one check over the
gathered strip decides whether that answer is provably exact; where it is
not (boundary ties, a NaN), the batch falls back to a blocked sort.  That
check is one host read per request.  Small sorts are stable descending
``torch.sort``s: ``torch.topk`` promises no order among ties.

``recall_target < 1`` asks ``tpunmf`` for ``lax.approx_max_k``, a TPU
primitive with no torch counterpart: here it takes the exact path, so the
recall is 1 >= target.

``mesh=`` (a mesh with a 'cols' axis, ``tpunmf_torch.parallel``) shards H
by columns (tpunmf/serve/topk.py:356-531): every rank passes the global H
(and exclusion), ranks its own column panel as one device would, offsets
its candidates' indices by ``rank_on_cols * n_local``, all-gathers them
over 'cols' and takes the final top k in ``lax.top_k``'s order, so every
rank returns the same answer.  A mesh without a 'cols' axis takes the
one-device path.

The fused scoring kernel is gated by ``TPUNMF_FUSED_SCORING`` (read at
each call; 1/0, true/false, yes/no in any case; default on).  With the
gate off, with exclusions, or above the kernel's rank bound, the scores
come from ``torch.matmul`` and the block maxima from the
``blockmax_relayout`` kernel.  On the CPU both kernels' wrappers run their
plain versions.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..core.device import as_input
from ..core.precision import full_f32
from ..data.pipeline import PanelPipeline
from ..ops.topk_select import (blockmax_relayout, score_blockmax_fits,
                               score_blockmax_relayout)
from ..parallel.collectives import all_gather
from ..parallel.mesh import axis_index, axis_size, has_axis

_TOPK_BLOCK = 16384
# candidate sets wider than this use a second block-max level
_WIDE_TOPK_MIN = 16384
_WIDE_INNER_BLOCK = 8
_WIDE_INNER_EXTRA = 32
_FIRST_STAGE_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}
_GATE = "TPUNMF_FUSED_SCORING"
_TRUE = ("1", "true", "yes")
_FALSE = ("0", "false", "no")


def _fused_scoring() -> bool:
    value = os.environ.get(_GATE, "1").strip().lower()
    if value not in _TRUE + _FALSE:
        raise ValueError(f"{_GATE}={value!r}: use one of 1/0, true/false, yes/no")
    return value in _TRUE


def _topk(x, k: int):
    """``lax.top_k`` along the last axis: value descending, ties to the
    lowest index, NaN first (a stable descending sort, then a slice)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x, idx):
    return torch.gather(x, 1, idx)


def _blocked_topk(scores, k: int, block: int = _TOPK_BLOCK):
    """Exact top-k via per-block top-k + merge (the fallback of
    :func:`_exact_topk_core`).  Candidates are laid out block-major with
    index-ordered ties inside each block, so the merge keeps the tie
    order."""
    b, n = scores.shape
    if n <= 2 * block or k >= block:
        return _topk(scores, k)
    nb = -(-n // block)
    if nb * block != n:
        pad = torch.full((b, nb * block - n), -torch.inf, dtype=scores.dtype,
                         device=scores.device)
        scores = torch.cat([scores, pad], dim=1)
    vals, idx = _topk(scores.reshape(b, nb, block), k)
    base = (torch.arange(nb, device=idx.device) * block)[None, :, None]
    gidx = (idx + base).reshape(b, nb * k)
    v2, pos = _topk(vals.reshape(b, nb * k), k)
    return v2, _take(gidx, pos)


def _wide_topk(flat, kk: int):
    """top-kk of a wide (b, c) candidate matrix via a second block-max
    level (tpunmf/serve/topk.py:121-142).  Not tie-exact on its own: the
    caller's check covers it.  c is a multiple of _WIDE_INNER_BLOCK."""
    b, c = flat.shape
    ib = _WIDE_INNER_BLOCK
    nb2 = c // ib
    f3 = flat.reshape(b, nb2, ib)
    m2 = torch.amax(f3, dim=-1)
    ks2 = min(kk + _WIDE_INNER_EXTRA, nb2)
    _, b2 = _topk(m2, ks2)
    g2 = torch.gather(f3, 1, b2[:, :, None].expand(b, ks2, ib)).reshape(b, ks2 * ib)
    v, p = _topk(g2, kk)
    return v, _take(b2, torch.div(p, ib, rounding_mode="floor")) * ib + p % ib


def _exact_topk_core(bmax, s3, n: int, k: int, *, sel_block: int = 128,
                     sel_extra: int = 8, block: int = _TOPK_BLOCK, scores=None):
    """Top-k from a (block maxima, relayout) pair (tpunmf/serve/topk.py:145-236).

    The k-th largest block maximum bounds the k-th value from below, so
    every element at or above it lies in one of the top (k + sel_extra)
    blocks by maximum.  Those blocks are gathered, their top (k +
    sel_extra) taken, and the result re-sorted by (value desc, index
    asc).  The answer is accepted when the k-th value tau exceeds the best
    unselected block maximum, the gathered strip holds as many elements
    above and at tau as the candidates, no NaN was gathered and tau is
    above the padding; that is one host read for the whole batch.
    Otherwise the batch takes the blocked sort of ``scores`` (rebuilt from
    ``s3`` when None)."""
    b, nb = bmax.shape
    ksel = min(k + sel_extra, nb)
    if ksel < nb:
        bvals, bidx_all = _topk(bmax, ksel + 1)
        bidx = bidx_all[:, :ksel]
        m_next = bvals[:, ksel:ksel + 1]
    else:
        _, bidx = _topk(bmax, ksel)
        m_next = torch.full((b, 1), -torch.inf, dtype=bmax.dtype, device=bmax.device)
    gath = torch.gather(s3, 1, bidx[:, :, None].expand(b, ksel, sel_block))
    c = ksel * sel_block
    kk = min(k + sel_extra, c)
    flat = gath.reshape(b, c)
    if c > _WIDE_TOPK_MIN and kk < c // _WIDE_INNER_BLOCK:
        v1, p1 = _wide_topk(flat, kk)
    else:
        v1, p1 = _topk(flat, kk)
    gidx = (_take(bidx, torch.div(p1, sel_block, rounding_mode="floor")) * sel_block
            + p1 % sel_block)
    # lax.top_k's tie order: a stable sort by index, then by value
    order = torch.argsort(gidx, dim=1, stable=True)
    v1, gidx = _take(v1, order), _take(gidx, order)
    order = torch.argsort(v1, dim=1, descending=True, stable=True)
    vals_sorted, idx_sorted = _take(v1, order), _take(gidx, order)
    tau = vals_sorted[:, k - 1:k]

    lo = torch.finfo(s3.dtype).min
    gt_cand = torch.sum(vals_sorted > tau, dim=1)
    eq_cand = torch.sum(vals_sorted == tau, dim=1)
    gt_gath = torch.sum(flat > tau, dim=1)
    eq_gath = torch.sum(flat == tau, dim=1)
    fast_ok = (torch.all(tau > m_next)
               & torch.all((gt_gath == gt_cand) & (eq_gath == eq_cand))
               & ~torch.any(torch.isnan(flat)) & torch.all(tau > lo))
    if bool(fast_ok):
        return vals_sorted[:, :k], idx_sorted[:, :k]
    if scores is None:
        scores = s3.reshape(b, nb * sel_block)[:, :n]
    return _blocked_topk(scores, k, block)


def _exact_topk(scores, k: int, block: int = _TOPK_BLOCK, sel_block: int = 128,
                sel_extra: int = 8):
    """Exact top-k over a wide item axis by block-max selection (the
    ``blockmax_relayout`` kernel, then :func:`_exact_topk_core`)."""
    n = scores.shape[1]
    if n <= 2 * block or k >= block:
        return _topk(scores, k)
    bmax, s3 = blockmax_relayout(scores, sel_block)
    return _exact_topk_core(bmax, s3, n, k, sel_block=sel_block,
                            sel_extra=sel_extra, block=block, scores=scores)


def _acc_type(w_batch, h):
    """Scoring accumulation/output dtype: at least float32 (a bfloat16
    output ties scores), never below the inputs' (float64 stays)."""
    return torch.promote_types(torch.promote_types(w_batch.dtype, h.dtype),
                               torch.float32)


@full_f32()
def _score(w_batch, h):
    """w_batch @ h in :func:`_acc_type`: both operands are upcast, since
    ``torch.matmul`` of bfloat16 tensors returns bfloat16."""
    acc = _acc_type(w_batch, h)
    return torch.matmul(w_batch.to(acc), h.to(acc))


def _scored_topk(w_batch, h, k: int, block: int = _TOPK_BLOCK,
                 sel_block: int = 128, sel_extra: int = 8):
    """Score and take the exact top-k, through the fused scoring kernel
    when the gate is on and it takes the shape."""
    b, r = w_batch.shape
    n = h.shape[1]
    if n <= 2 * block or k >= block:
        return _topk(_score(w_batch, h), k)
    if (_fused_scoring() and _acc_type(w_batch, h) == torch.float32
            and score_blockmax_fits(b, r, h.element_size(), sel_block)):
        bmax, s3 = score_blockmax_relayout(w_batch, h, sel_block)
        return _exact_topk_core(bmax, s3, n, k, sel_block=sel_block,
                                sel_extra=sel_extra, block=block)
    return _exact_topk(_score(w_batch, h), k, block=block, sel_block=sel_block,
                       sel_extra=sel_extra)


def _tensors(w_batch, h, exclude=None):
    """The inputs as tensors on H's device (exclusion as bool); H that is
    not a tensor goes to the CUDA device (core/device.py)."""
    h = as_input(h)
    w_batch = as_input(w_batch, device=h.device)
    if exclude is not None:
        exclude = as_input(exclude, dtype=torch.bool, device=h.device)
    return w_batch, h, exclude


def topk_scores_dense(w_batch, h, k: int):
    """Single-device scoring + top-k: returns (values, item_indices)."""
    w_batch, h, _ = _tensors(w_batch, h)
    with torch.no_grad():
        return _scored_topk(w_batch, h, k)


def _quantized_rerank(w_batch, h, k: int, dtype_name: str, oversample: int,
                      exclude=None, hq=None):
    """Two-stage retrieve-then-rerank (tpunmf/serve/topk.py:293-343).

    Stage 1 scores every item in bfloat16/float16 (float32 accumulation
    and output) and keeps ``oversample * k`` candidates; stage 2 rescores
    those candidates' columns of H exactly and takes the top k.  ``hq``
    is a pre-stored low-precision copy of H, which is what saves stage
    1's bytes; without it H is cast here."""
    q = _FIRST_STAGE_DTYPES[dtype_name]
    n = h.shape[1]
    c = min(oversample * k, n)
    if hq is None:
        hq = h.to(q)
    if exclude is None:
        _, cand = _scored_topk(w_batch.to(q), hq, c)
    else:
        scores_q = _score(w_batch.to(q), hq)
        scores_q = torch.where(exclude, -torch.inf, scores_q)
        _, cand = _exact_topk(scores_q, c)
    acc = torch.promote_types(w_batch.dtype, h.dtype)
    h_cand = h.T[cand].to(acc)                             # (b, c, r)
    with full_f32():
        scores = torch.bmm(h_cand, w_batch.to(acc)[:, :, None])[:, :, 0]
    if exclude is not None:
        scores = torch.where(_take(exclude, cand), -torch.inf, scores)
    vals, pos = _topk(scores, k)
    return vals, _take(cand, pos)


def topk_retrieval(mesh, w_batch, h, k: int, exclude=None,
                   recall_target: float = 1.0,
                   first_stage_dtype: str | None = None,
                   oversample: int = 2, h_quantized=None):
    """Top-k item retrieval for a batch of user factors.

    Args:
      mesh: a mesh with a 'cols' axis (H column-sharded, every rank
        passing the global H), or None for one device.
      w_batch: (b, r) user factor rows.
      h: (r, n) item factors.
      k: number of items to return per user.
      exclude: optional (b, n) bool mask of items to exclude (e.g. already
        interacted), applied before ranking.
      recall_target: accepted for ``tpunmf``'s signature; every value
        takes the exact path (recall 1).
      first_stage_dtype: None (exact float32 scoring) or 'bf16'/'f16':
        score every item in that dtype first, keep ``oversample * k``
        candidates, then rescore their columns of H exactly.
      oversample: candidate multiplier for the quantized first stage.
        Default 2, chosen by ``tpunmf`` on uniform random factors only;
        raise it for catalogs with near-tied scores.
      h_quantized: optional pre-stored copy of ``h`` in the
        ``first_stage_dtype`` dtype (same (r, n) shape): the byte saving
        of the first stage.  Without it the cast happens per call (the
        same result).

    Returns: (values (b, k), indices (b, k) int64).
    """
    if first_stage_dtype is not None and first_stage_dtype not in _FIRST_STAGE_DTYPES:
        raise ValueError("first_stage_dtype must be None, 'bf16' or 'f16'")
    if h_quantized is not None:
        if first_stage_dtype is None:
            raise ValueError("h_quantized requires first_stage_dtype")
        if h_quantized.dtype != _FIRST_STAGE_DTYPES[first_stage_dtype]:
            raise ValueError(
                f"h_quantized dtype {h_quantized.dtype} does not match "
                f"first_stage_dtype {first_stage_dtype!r}")
    if mesh is not None and has_axis(mesh, "cols"):
        n, p = h.shape[1], axis_size(mesh, "cols")
        if n % p:
            raise ValueError(f"items axis {n} not divisible by 'cols'={p}")
        lo = axis_index(mesh, "cols") * (n // p)

        def own(a):
            return None if a is None else a[:, lo:lo + n // p]

        w_batch, h_loc, excl_loc = _tensors(w_batch, own(h), own(exclude))
        hq_loc = None if h_quantized is None else own(h_quantized).contiguous()
        return _sharded_topk(mesh, w_batch, h_loc.contiguous(), k, excl_loc,
                             first_stage_dtype, oversample, hq_loc)
    w_batch, h, exclude = _tensors(w_batch, h, exclude)
    return _one_device_topk(w_batch, h, k, exclude, first_stage_dtype, oversample,
                            h_quantized)


def _one_device_topk(w_batch, h, k, exclude, first_stage_dtype, oversample, hq):
    with torch.no_grad():
        if first_stage_dtype is not None:
            return _quantized_rerank(w_batch, h, k, first_stage_dtype, oversample,
                                     exclude=exclude, hq=hq)
        if exclude is None:
            return _scored_topk(w_batch, h, k)
        scores = torch.where(exclude, -torch.inf, _score(w_batch, h))
        return _exact_topk(scores, k)


def _sharded_topk(mesh, w_batch, h_loc, k, excl_loc, first_stage_dtype, oversample, hq_loc):
    """The global top k from this rank's column panel of H: the panel's
    top min(k, n_local) as one device ranks it, indices offset to global
    ones, the candidates of every rank on 'cols' gathered and re-ranked."""
    n_local = h_loc.shape[1]
    vals, idx = _one_device_topk(w_batch, h_loc, min(k, n_local), excl_loc,
                                 first_stage_dtype, oversample, hq_loc)
    idx = idx + axis_index(mesh, "cols") * n_local
    all_vals = all_gather(vals, mesh, "cols", dim=1)
    all_idx = all_gather(idx, mesh, "cols", dim=1)
    with torch.no_grad():
        out_vals, pos = _topk(all_vals, k)
    return out_vals, _take(all_idx, pos)


def _merge_topk(vals_a, idx_a, vals_b, idx_b, k: int):
    """Merge two (b, >=k) candidate sets into the top k."""
    vals = torch.cat([vals_a, vals_b], dim=1)
    idx = torch.cat([idx_a, idx_b], dim=1)
    out_vals, pos = _topk(vals, k)
    return out_vals, _take(idx, pos)


def topk_streaming(w_batch, h_source, n: int, k: int, *,
                   panel_cols: int = 65536, mesh=None, exclude=None,
                   recall_target: float = 1.0,
                   first_stage_dtype: str | None = None,
                   oversample: int = 2):
    """Top-k retrieval when H does not fit on the device.

    Column panels of H, ``h_source[:, start:stop]`` (a numpy array or
    memmap) or ``h_source(start, stop)``, go from the host to
    ``w_batch``'s device (:func:`_device_panels`: on the card through a
    ring of pinned buffers and a copy stream, a float64 panel as float32,
    so panel t is ranked while the next ones are copied), are ranked by
    :func:`topk_retrieval`, and merged into a running (b, k) candidate
    set.  A ragged last panel is ranked at its own width (on one device it
    needs no padding).  Where
    fewer than k items remain after ``exclude`` (a (b, n) bool host
    array), the -inf-scored slots carry index -1.

    With ``mesh=`` (a 'cols' axis) each panel is padded with zero columns
    to a multiple of the shard count and the pad masked through the
    exclusion path (tpunmf/serve/topk.py:539-625); each rank copies only
    its own columns of each panel to its device and ranks them as
    :func:`topk_retrieval`'s sharded path does.

    Returns: (values (b, k), indices (b, k) int64).
    """
    if k > n:
        raise ValueError(f"k={k} exceeds the item count n={n}")
    sharded = mesh is not None and has_axis(mesh, "cols")
    shards = axis_size(mesh, "cols") if sharded else 1
    rank = axis_index(mesh, "cols") if sharded else 0
    w_batch = as_input(w_batch)
    device = w_batch.device
    take = min(panel_cols, n)
    slicer = h_source if callable(h_source) else (lambda s, e: h_source[:, s:e])

    def own(span):
        """This rank's columns [lo, hi) of the panel padded to a multiple
        of the shards, and the padded width it ranks."""
        start, stop = span
        width = -(-(stop - start) // shards)
        lo = min(start + rank * width, stop)
        return lo, min(lo + width, stop), width

    b = w_batch.shape[0]
    vals = None
    idx = torch.full((b, k), -1, dtype=torch.int64, device=device)
    spans = [(start, min(start + take, n)) for start in range(0, n, take)]
    for start, stop, panel in _device_panels(slicer, spans, device, own):
        lo, hi, width = own((start, stop))
        padded = (stop - start) % shards != 0
        excl = None
        if exclude is not None or padded:
            # ragged tail: the pad columns can never enter the candidates
            excl = np.ones((b, width), dtype=bool)
            excl[:, :hi - lo] = False if exclude is None else np.asarray(exclude[:, lo:hi])
        if sharded:
            excl = None if excl is None else as_input(excl, device=device)
            p_vals, p_idx = _sharded_topk(mesh, w_batch, panel,
                                          min(k, width * shards), excl,
                                          first_stage_dtype, oversample, None)
        else:
            p_vals, p_idx = topk_retrieval(
                None, w_batch, panel, min(k, stop - start), exclude=excl,
                recall_target=recall_target, first_stage_dtype=first_stage_dtype,
                oversample=oversample)
        if vals is None:
            # candidates keep the scores' dtype across the merges
            vals = torch.full((b, k), -torch.inf, dtype=p_vals.dtype, device=device)
        vals, idx = _merge_topk(vals, idx, p_vals.to(vals.dtype), p_idx + start, k)
    # -inf-scored candidates (exclusion, padding) may carry real item ids:
    # scrub them
    idx = torch.where(torch.isneginf(vals), torch.full_like(idx, -1), idx)
    return vals, idx


def _device_panels(slicer, spans, device, own):
    """Yield (start, stop, panel on ``device``) over ``spans``: the panel
    is this rank's columns of the span, ``own(span)`` = (lo, hi, width),
    zero-padded to ``width`` (one device: the whole span).

    A float64 host panel is scored in float32 on the card, as
    topk_retrieval's own H is (tpunmf/serve/topk.py:590, 607): on the
    CPU the panels go through ``as_input``; on the card the source's type
    sets the ring's (``as_input``'s rule), and each panel is cast while it
    is copied into its pinned buffer (``data/pipeline.py``)."""
    # the first panel gives the rows and the type (a rank whose columns of
    # it are all padding reads one column of the source instead)
    lo, hi, _ = own(spans[0])
    first = np.asarray(slicer(lo, hi) if hi > lo else slicer(spans[0][0], spans[0][0] + 1))
    fetched = {spans[0]: first} if hi > lo else {}
    rows = first.shape[0]

    def host_panel(span):
        lo, hi, width = own(span)
        src = fetched.pop(span, None)
        if src is None and hi > lo:
            src = np.asarray(slicer(lo, hi))
        if hi - lo == width:
            return src
        out = np.zeros((rows, width), dtype=first.dtype)
        out[:, :hi - lo] = src if hi > lo else 0
        return out

    if device.type != "cuda":
        for start, stop in spans:
            yield start, stop, as_input(host_panel((start, stop)), device=device)
        return
    dtype = torch.from_numpy(np.empty(0, dtype=first.dtype)).dtype
    if dtype == torch.float64:
        dtype = torch.float32
    ring = PanelPipeline(rows * own(spans[0])[2], dtype, device)

    def fill(span, host):
        with warnings.catch_warnings():
            # a read-only source (a memmap) is only read here
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            host.copy_(torch.from_numpy(host_panel(span)))

    for (start, stop), panel in ring.run(spans, fill, lambda span: (rows, own(span)[2])):
        yield start, stop, panel


def recall_at_k(pred_idx, true_idx) -> float:
    """Mean recall@k between predicted and ground-truth index sets.

    pred_idx: (b, k) retrieved items; true_idx: (b, t) relevant items
    (negative entries are padding; all-padding rows are left out)."""
    pred = _host(pred_idx)
    true = _host(true_idx)
    hits = 0.0
    evaluated = 0
    for p_row, t_row in zip(pred, true):
        t = set(int(i) for i in t_row if i >= 0)
        if not t:
            continue
        evaluated += 1
        hits += len(t.intersection(int(i) for i in p_row)) / len(t)
    return hits / evaluated if evaluated else 0.0


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
