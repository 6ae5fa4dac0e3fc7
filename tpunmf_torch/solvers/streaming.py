"""Out-of-core MUR: factorize matrices larger than device memory, on PyTorch.

Same contract as ``tpunmf.solvers.streaming.mur_streaming``
(tpunmf/solvers/streaming.py:176-339): X, a scipy sparse matrix, stays on
the host as CSR and streams through the device as dense panels (native
panelizer -> pinned ring -> copy stream, ``data/pipeline.py``), while W,
H, W's numerator, the panels in flight and k x k Grams are resident (W is
updated a row block at a time, into its numerator):

  per iteration (Euclidean):
    G_h = H H^T                         (device, k x k)
    numer_W = sum_j X[:, j] @ H[:, j]^T (streamed pass, row-major tiles)
    W <- W * numer_W / (W G_h + lw*W + eps)
    numer_H = W^T X                     (streamed pass, column-major tiles)
    G_w = W^T W
    H <- H * numer_H / (G_w H + lh*H + eps)
    obj = 0.5*(||X||^2 - 2<H, numer_H> + tr(G_w (H H^T)))   (no pass)

  KL: the two numerator passes form each tile's ratio X / (W H + eps),
  and the objective is a third pass over the nonempty tiles; an all-zero
  tile adds exactly colsum(W_i) . rowsum(H_j), so it is never densified.

Tiles with no nonzero (``skip_empty_panels``) are skipped in every pass:
there X = 0, so their numerator terms are exactly 0.  Ragged edge tiles are
zero-padded; the padded rows are left out of the products and the padded
columns meet zero columns of H, so they add exactly nothing.

On the card, where ``fused.objective_takes`` takes the panels (float32 or
bfloat16, k <= 2048) and the factors are float32, each KL tile's ratio is
``fused.kl_ratio`` and its objective ``fused.kl_obj`` (the kernels'
launches count); the products stay ``torch.matmul`` (``addmm_`` into the
accumulator), as do the EU tiles.  ``use_pallas=False``, float64 factors
and CPU state take the plain versions.  Each panel is cast to the
factors' type before its product (JAX promotes an f32 panel times f64
factors to f64).

Convergence semantics are ``mur``'s: ``convergence_check`` after
iteration i only when i > min_iter.

The update rules with their numerators given are the port's one copy of
tpunmf/solvers/streaming.py:81-102; they take one (m, k) / (k, n) pair or
a batch (B, m, k) / (B, k, n) (``experiments.py`` runs its grids on them).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.convergence import convergence_check
from ..core.device import as_input, state_device
from ..core.losses import eu_objective_gram
from ..core.precision import full_f32
from ..core.types import MurExperiment, Results
from ..data.pipeline import SLOTS, PanelPipeline
from ..data.sparse_panels import PanelStream, to_bf16
from ..init import random_init
from ..ops.fused import kl_obj, kl_obj_ref, kl_ratio, kl_ratio_ref, objective_takes
from .common import host_array

_EPS = 1e-9
# pinned host buffers and device panels in the ring
RING_SLOTS = SLOTS


def _mur_w_update_eu(w, numer, gram_h, lam):
    return w * numer / (w @ gram_h + lam * w + _EPS)


def _mur_h_update_eu(h, numer, gram_w, lam):
    return h * numer / (gram_w @ h + lam * h + _EPS)


def _kl_closed_form(a, b, lam):
    """The regularized KL update 2a / (b + sqrt(b^2 + 4 lam a)), a the
    factor times its numerator and b the other factor's sums."""
    return 2.0 * a / (b + torch.sqrt(b * b + 4.0 * lam * a))


def _mur_w_update_kl(w, numer, h, lam):
    return _kl_closed_form(w * numer, torch.sum(h, dim=-1).unsqueeze(-2), lam)


def _mur_h_update_kl(h, numer, w, lam):
    return _kl_closed_form(h * numer, torch.sum(w, dim=-2).unsqueeze(-1), lam)


class _Panels:
    """Panel access with the nnz-based skip, through the pinned ring."""

    def __init__(self, x_sparse, row_block, col_panel, skip_empty, transfer_dtype, device):
        self.stream = PanelStream(x_sparse, row_block=row_block, col_panel=col_panel)
        self.m, self.n = self.stream.m, self.stream.n
        self.rb, self.cb = self.stream.grid
        self.row_block, self.col_panel = self.stream.row_block, self.stream.col_panel
        self.transfer_bf16 = transfer_dtype == torch.bfloat16
        self.panel_dtype = torch.bfloat16 if self.transfer_bf16 else torch.float32
        self.nonempty = {
            (i, j)
            for i in range(self.rb)
            for j in range(self.cb)
            if not skip_empty or self.stream.panel_nnz(i, j) > 0
        }
        self.ring = PanelPipeline(self.row_block * self.col_panel, self.panel_dtype, device,
                                  slots=RING_SLOTS)
        # the tile each ring buffer holds, so that filling it clears that
        # tile's nonzeros instead of zeroing the buffer
        self._held = {}

    def _fill(self, ij, host):
        held = self._held.get(host.data_ptr())
        if self.transfer_bf16:
            # transfer compression: bf16 panels halve host->device bytes
            self.stream.panel_bf16(*ij, out=host, holds=held)
        else:
            self.stream.panel(*ij, out=host.numpy(), holds=held)
        self._held[host.data_ptr()] = ij

    def schedule(self, row_major=True):
        """The nonempty tiles, row-major (W-side passes and the objective)
        or column-major (the W^T X pass), as ``tpunmf`` orders them."""
        if row_major:
            order = ((i, j) for i in range(self.rb) for j in range(self.cb))
        else:
            order = ((i, j) for j in range(self.cb) for i in range(self.rb))
        return [ij for ij in order if ij in self.nonempty]

    def pipelined(self, sched):
        """Yield ((i, j), device panel) over ``sched``: panel t on the card
        while the next ones are densified and copied."""
        shape = (self.row_block, self.col_panel)
        return self.ring.run(sched, self._fill, lambda ij: shape)

    def rows(self, i):
        return min(self.row_block, self.m - i * self.row_block)

    def cols(self, j):
        return min(self.col_panel, self.n - j * self.col_panel)

    def h_panels(self, h):
        """H's column panels, zero-padded to full width, as one contiguous
        (cb, k, col_panel) tensor (H is padded once a pass, not a tile)."""
        k = h.shape[0]
        hp = torch.nn.functional.pad(h, (0, self.cb * self.col_panel - self.n))
        return hp.reshape(k, self.cb, self.col_panel).transpose(0, 1).contiguous()


def mur_streaming(
    x_sparse,
    k: int,
    *,
    distance_type: str = "eu",
    min_iter: int = 10,
    max_iter: int = 200,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    row_block: int = 4096,
    col_panel: int = 4096,
    key=None,
    w_init=None,
    h_init=None,
    dtype=torch.float32,
    skip_empty_panels: bool = True,
    transfer_dtype=None,
    verbose: bool = False,
    device=None,
    use_pallas=None,
) -> Results:
    """MUR on a scipy sparse matrix streamed through the device in panels.

    ``tpunmf``'s keywords and ``Results``.  Panels are densified in float32
    by the host panelizer regardless of ``dtype`` (the factors' and
    accumulators' type); ``transfer_dtype=torch.bfloat16`` densifies
    straight to bf16, halving host->device bytes (the recorded objective is
    then the objective of the bf16-rounded data).  ``key`` is a
    ``torch.Generator`` or an int seed for the random |N(0,1)| init
    (default 0; torch's draws differ from ``jax.random``'s, so parity runs
    pass ``w_init`` and ``h_init``).

    The state lives on the inits' device when they are tensors, else on
    ``device`` (default ``cuda``: without a card this raises; pass
    ``device="cpu"`` or CPU tensors for a CPU run).  ``use_pallas``: the
    KL tiles' kernels on/off (default: on for a CUDA state).
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if transfer_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError("transfer_dtype must be None/float32/bfloat16")
    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    dev = state_device(w_init, device)

    p = _Panels(x_sparse, row_block, col_panel, skip_empty_panels, transfer_dtype, dev)
    m, n = p.m, p.n
    if w_init is not None:
        w = as_input(w_init, dtype=dtype, device=dev).contiguous()
        h = as_input(h_init, dtype=dtype, device=dev).contiguous()
    else:
        w, h = random_init(key, m, n, k, kind="abs_normal", dtype=dtype, device=dev)

    experiment = MurExperiment(
        method="mur", components=k, distance_type=distance_type,
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )

    if use_pallas is None:
        use_pallas = dev.type == "cuda"
    kernels = (bool(use_pallas) and dtype == torch.float32
               and objective_takes(torch.empty((), dtype=p.panel_dtype, device="meta"), k))
    ratio_of, obj_of = (kl_ratio, kl_obj) if kernels else (kl_ratio_ref, kl_obj_ref)

    # ||X||^2 from the deduplicated CSR (COO duplicates sum there); with
    # bf16 transfer the device fits the bf16-ROUNDED data, so ||X||^2 takes
    # the rounded values too
    data = p.stream.csr.data
    if p.transfer_bf16:
        data = to_bf16(torch.from_numpy(np.asarray(data, dtype=np.float32))).double().numpy()
    xsq = float(np.sum(np.asarray(data, dtype=np.float64) ** 2))

    def streamed_xht(w, h, kl):
        """sum_j X_panel @ h_panel^T into each row block (EU), or the KL
        ratio's; one pipelined pass over the nonempty tiles, row-major."""
        hps = p.h_panels(h)
        out = torch.zeros((m, k), dtype=dtype, device=dev)
        for (i, j), x in p.pipelined(p.schedule()):
            r0, rows = i * p.row_block, p.rows(i)
            xi = x[:rows]
            if kl:
                xi = ratio_of(xi, w[r0:r0 + rows], hps[j], eps=_EPS)
            out[r0:r0 + rows].addmm_(xi.to(dtype), hps[j].T)
        return out

    def streamed_wtx(w, h, kl):
        """W^T X (EU) or W^T (X / (W H + eps)) (KL), one accumulator per
        column panel, trimmed and joined; column-major tiles."""
        hps = p.h_panels(h) if kl else None
        accs = [torch.zeros((k, p.col_panel), dtype=dtype, device=dev) for _ in range(p.cb)]
        for (i, j), x in p.pipelined(p.schedule(row_major=False)):
            r0, rows = i * p.row_block, p.rows(i)
            w_block, xi = w[r0:r0 + rows], x[:rows]
            if kl:
                xi = ratio_of(xi, w_block, hps[j], eps=_EPS)
            accs[j].addmm_(w_block.T, xi.to(dtype))
        return torch.cat([acc[:, :p.cols(j)] for j, acc in enumerate(accs)], dim=1)

    def kl_objective(w, h):
        """Masked KL objective: a pass over the nonempty tiles, and each
        empty tile's exact sum(w_i h_j) = colsum(W_i) . rowsum(H_j) (its x
        terms vanish and the reference's masking zeroes 0*log(0))."""
        hps = p.h_panels(h)
        obj = torch.zeros((), dtype=dtype, device=dev)
        for (i, j), x in p.pipelined(p.schedule()):
            r0, rows = i * p.row_block, p.rows(i)
            obj = obj + obj_of(x[:rows], w[r0:r0 + rows], hps[j]).to(dtype)
        empty = [(i, j) for i in range(p.rb) for j in range(p.cb) if (i, j) not in p.nonempty]
        if empty:
            w_colsums = [torch.sum(w[i * p.row_block:i * p.row_block + p.rows(i)], dim=0)
                         for i in range(p.rb)]
            h_rowsums = [torch.sum(hps[j], dim=1) for j in range(p.cb)]
            for i, j in empty:
                obj = obj + torch.dot(w_colsums[i], h_rowsums[j])
        return float(obj)

    def eu_objective(wtx, gram_w, h):
        return float(eu_objective_gram(xsq, wtx, gram_w, h))

    def w_update(rule, w, numer, *args):
        """W's update a row block at a time, into its numerator: no m x k
        temporaries beside W and the numerator."""
        for i in range(p.rb):
            r0, r1 = i * p.row_block, i * p.row_block + p.rows(i)
            numer[r0:r1] = rule(w[r0:r1], numer[r0:r1], *args)
        return numer

    with torch.no_grad(), full_f32():
        if distance_type == "eu":
            obj_history = [eu_objective(streamed_wtx(w, h, False), w.T @ w, h)]
        else:
            obj_history = [kl_objective(w, h)]

        i = 0
        for i in range(max_iter):
            if distance_type == "eu":
                gram_h = h @ h.T
                w = w_update(_mur_w_update_eu, w, streamed_xht(w, h, False), gram_h,
                             lambda_w)
                numer_h = streamed_wtx(w, h, False)
                gram_w = w.T @ w
                h = _mur_h_update_eu(h, numer_h, gram_w, lambda_h)
                obj_history.append(eu_objective(numer_h, gram_w, h))
            else:
                w = w_update(_mur_w_update_kl, w, streamed_xht(w, h, True), h, lambda_w)
                h = _mur_h_update_kl(h, streamed_wtx(w, h, True), w, lambda_h)
                obj_history.append(kl_objective(w, h))

            if verbose:
                print(f"[{i}]: {obj_history[-1]}")
            if i > min_iter and convergence_check(obj_history[-1], obj_history[-2], tol1,
                                                  tol2):
                break

    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)
