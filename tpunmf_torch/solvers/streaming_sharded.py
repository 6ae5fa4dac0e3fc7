"""Sharded out-of-core MUR: recommender-scale V streamed through a mesh.

The port's copy of ``tpunmf.solvers.streaming_sharded``
(tpunmf/solvers/streaming_sharded.py:113-348).  H lives column-sharded
(None, 'cols') across the mesh and is never gathered in the loop; W is
replicated; V stays on the host as CSR and streams in ROW BLOCKS, of which
each rank densifies only its own column range (``PanelStream`` with
``col_panel = n / cols``) through its own ring of pinned buffers
(``data/pipeline.py``; on the CPU the plain loop).  The row block's
``X_i H^T`` contracts over the sharded columns: one all_reduce over
'cols' a block.

Euclidean, one streamed pass an iteration:
  G_h = H H^T                       (all_reduce over 'cols')
  for each row block i:
      numer_i = X_i @ H^T           (all_reduce over 'cols')
      W_i    <- W_i * numer_i / (W_i G_h + lw W_i + eps)
      WtX    += W_i^T X_i           (with the fresh W_i; stays sharded)
  H <- mur update (local on each rank's columns)
  obj by the Gram trick (one all_reduce of <H, WtX> and H H^T)

KL: each block's ratio X_i / (W_i H + eps) is formed on the rank's
columns (``fused.kl_ratio`` on the card), its products reduce the same
way, H's row sums are all-reduced once an iteration, and the exact
objective is its own pass (2 streams an iteration) unless
``objective='lagged'`` folds iteration t's objective into iteration t+1's
ratio pass (``fused.kl_ratio_and_obj``; 1 stream, the trace shifted by
one iteration).  Each rank's objective partials are all-reduced once a
pass.

Memory on a rank: its H columns (k x n/p), W (m x k), the ring's row
block panels (row_block x n/p) — V itself is never resident.

Every rank passes the same global CSR and inits; every rank returns the
same ``Results`` (H gathered to the host).  The stop is decided from the
all-reduced objective, the same bits on every rank.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.convergence import convergence_check
from ..core.device import as_input
from ..core.precision import full_f32
from ..core.types import MurExperiment, Results
from ..data.sparse_panels import to_bf16
from ..init import random_init
from ..ops.fused import (kl_obj, kl_obj_ref, kl_ratio, kl_ratio_and_obj, kl_ratio_and_obj_ref,
                         kl_ratio_ref, objective_takes)
from ..parallel.collectives import all_gather, all_reduce, broadcast
from ..parallel.mesh import axis_index, axis_size, has_axis, mesh_device
from .common import host_array
from .streaming import (_Panels, _kl_closed_form, _mur_h_update_eu, _mur_h_update_kl,
                        _mur_w_update_eu)

_EPS = 1e-9


def mur_streaming_sharded(
    x_sparse,
    k: int,
    mesh,
    *,
    distance_type: str = "eu",
    min_iter: int = 10,
    max_iter: int = 200,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    row_block: int = 8192,
    key=None,
    w_init=None,
    h_init=None,
    dtype=torch.float32,
    objective: str = "exact",
    prefetch: bool = False,
    transfer_dtype=None,
    verbose: bool = False,
    device=None,
    use_pallas=None,
) -> Results:
    """MUR (EU or KL) with column-sharded H and row-block-streamed V.

    ``tpunmf``'s keywords and ``Results``.  ``x_sparse``: a scipy sparse
    matrix (duplicate COO entries are summed); panels are densified in
    float32 (or straight to bf16 with ``transfer_dtype=torch.bfloat16``,
    the objective then that of the bf16-rounded data), ``dtype`` is the
    factors' and accumulators' type.  ``mesh``: a mesh with a 'cols' axis
    whose size divides n.  ``objective``: KL only, 'lagged' or (any other
    value) exact.
    ``prefetch`` is accepted; the ring always stages the next blocks while
    the device works on this one.  ``key``: a ``torch.Generator`` or int
    seed for the random |N(0,1)| init (default 0), made on rank 0 and
    broadcast.  ``device``: the state's device, the mesh's (another one
    raises).  ``use_pallas``: the KL tiles' kernels on/off (default: on
    for a CUDA mesh).
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if not has_axis(mesh, "cols"):
        raise ValueError("mesh must have a 'cols' axis")
    if transfer_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError("transfer_dtype must be None/float32/bfloat16")
    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    m, n = x_sparse.shape
    n_shards = axis_size(mesh, "cols")
    if n % n_shards:
        raise ValueError(f"n={n} must divide the 'cols' mesh size {n_shards}")
    col_shard = n // n_shards
    j_own = axis_index(mesh, "cols")
    c0 = j_own * col_shard
    dev = mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device={device!r}: the state lives on the mesh's device, {dev}")

    # each rank densifies only its own column panel of each row block
    p = _Panels(x_sparse, row_block, col_shard, False, transfer_dtype, dev)
    row_block = p.row_block  # PanelStream clamps to m
    blocks = [(i, j_own) for i in range(p.rb)]

    if w_init is not None:
        w = as_input(w_init, dtype=dtype, device=dev).contiguous()
        h_full = as_input(h_init, dtype=dtype, device=dev)
    else:
        w = torch.empty((m, k), dtype=dtype, device=dev)
        h_full = torch.empty((k, n), dtype=dtype, device=dev)
        if dist.get_rank() == 0:
            w0, h0 = random_init(key, m, n, k, kind="abs_normal", dtype=dtype, device=dev)
            w.copy_(w0)
            h_full.copy_(h0)
        broadcast(w)
        broadcast(h_full)
    h = h_full[:, c0:c0 + col_shard].contiguous()
    del h_full

    experiment = MurExperiment(
        method="mur", components=k, distance_type=distance_type,
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )

    if use_pallas is None:
        use_pallas = dev.type == "cuda"
    kernels = (bool(use_pallas) and dtype == torch.float32
               and objective_takes(torch.empty((), dtype=p.panel_dtype, device="meta"), k))
    ratio_of = kl_ratio if kernels else kl_ratio_ref
    obj_of = kl_obj if kernels else kl_obj_ref
    ratio_obj_of = kl_ratio_and_obj if kernels else kl_ratio_and_obj_ref

    # ||X||^2 from the deduplicated CSR; with bf16 transfer the device fits
    # the bf16-ROUNDED data, so ||X||^2 takes the rounded values too
    data = p.stream.csr.data
    if p.transfer_bf16:
        data = to_bf16(torch.from_numpy(np.asarray(data, dtype=np.float32))).double().numpy()
    xsq = float(np.sum(np.asarray(data, dtype=np.float64) ** 2))

    def streamed():
        """(first row, rows, this rank's panel of the row block) in order;
        the panel in its transfer type (the KL kernels take bf16 panels)."""
        for (i, _), x in p.pipelined(blocks):
            rows = p.rows(i)
            yield i * row_block, rows, x[:rows]

    def cols_sum(t):
        return all_reduce(t, mesh, "cols")

    def gram_objective(wtx, gram_w, h):
        """0.5 (||X||^2 - 2 <H, W^T X> + tr(G_w H H^T)), the sharded sums in
        one all_reduce."""
        packed = cols_sum(torch.cat([(h @ h.T).reshape(-1), torch.sum(h * wtx).reshape(1)]))
        gram_h, cross = packed[:-1].reshape(k, k), packed[-1]
        return float(0.5 * (xsq - 2.0 * cross + torch.sum(gram_w * gram_h)))

    def eu_pass(w, h, update):
        """One streamed pass: each block's W update (if ``update``) and
        the W^T X accumulation with the fresh W block."""
        gram_h = cols_sum(h @ h.T) if update else None
        wtx = torch.zeros((k, col_shard), dtype=dtype, device=dev)
        out = torch.empty_like(w) if update else w
        for r0, rows, xb in streamed():
            wb, xb = w[r0:r0 + rows], xb.to(dtype)
            if update:
                wb = _mur_w_update_eu(wb, cols_sum(xb @ h.T), gram_h, lambda_w)
                out[r0:r0 + rows] = wb
            wtx.addmm_(wb.T, xb)
        return out, wtx

    def kl_pass(w, h, lagged):
        """One streamed pass: each block's KL W update and the
        W^T (X / (W H + eps)) accumulation (and, lagged, the incoming
        iterate's objective)."""
        hsum = cols_sum(torch.sum(h, dim=1))[None, :]
        wtr = torch.zeros((k, col_shard), dtype=dtype, device=dev)
        obj_in = torch.zeros(1, dtype=dtype, device=dev)
        out = torch.empty_like(w)
        for r0, rows, xb in streamed():
            wb = w[r0:r0 + rows]
            if lagged:
                r, ob = ratio_obj_of(xb, wb, h, eps=_EPS)
                obj_in += ob.to(dtype)
            else:
                r = ratio_of(xb, wb, h, eps=_EPS)
            wb = _kl_closed_form(wb * cols_sum(r.to(dtype) @ h.T), hsum, lambda_w)
            out[r0:r0 + rows] = wb
            wtr.addmm_(wb.T, ratio_of(xb, wb, h, eps=_EPS).to(dtype))
        return out, wtr, (float(cols_sum(obj_in)[0]) if lagged else None)

    def kl_objective(w, h):
        obj = torch.zeros(1, dtype=dtype, device=dev)
        for r0, rows, xb in streamed():
            obj += obj_of(xb, w[r0:r0 + rows], h).to(dtype)
        return float(cols_sum(obj)[0])

    with torch.no_grad(), full_f32():
        if distance_type == "eu":
            # the Gram objective needs W^T X of the initial factors: one pass
            _, wtx0 = eu_pass(w, h, update=False)
            obj_history = [gram_objective(wtx0, w.T @ w, h)]
        elif objective == "lagged":
            obj_history = []  # filled by each iteration's ratio pass
        else:
            obj_history = [kl_objective(w, h)]

        i = 0
        for i in range(max_iter):
            if distance_type == "eu":
                w, wtx = eu_pass(w, h, update=True)
                gram_w = w.T @ w
                h = _mur_h_update_eu(h, wtx, gram_w, lambda_h)
                obj_history.append(gram_objective(wtx, gram_w, h))
            else:
                w, wtr, obj_in = kl_pass(w, h, objective == "lagged")
                h = _mur_h_update_kl(h, wtr, w, lambda_h)
                # lagged: obj_in is KL of the factors as of the END of the
                # previous iteration; it is recorded there
                obj_history.append(obj_in if objective == "lagged" else kl_objective(w, h))
            if verbose:
                print(f"[{i}]: {obj_history[-1]}")
            if i > min_iter and len(obj_history) >= 2 and convergence_check(
                    obj_history[-1], obj_history[-2], tol1, tol2):
                break
        h = all_gather(h, mesh, "cols", dim=1)

    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)
