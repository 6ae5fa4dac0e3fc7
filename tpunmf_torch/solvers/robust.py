"""Robust NMF — the l2,1-norm objective (outlier-resistant columns), on PyTorch.

Same contract as ``tpunmf.solvers.robust_nmf``: minimizes the *un-squared*
sum of column residual norms

    obj = sum_j || x_j - W h_j ||_2     (the l2,1 norm of X - WH),

by the multiplicative updates of Kong, Ding & Huang (CIKM 2011) with
per-column weights ``d_j = 1 / ||x_j - W h_j||``:

    H <- H * (W^T X D) / (W^T W H D),   W <- W * (X D H^T) / (W H D H^T).

The residual column norms come from the (k, n) cross-product and the
k x k Gram the updates already need, never from an m x n ``W @ H``:

    ||x_j - W h_j||^2 = ||x_j||^2 - 2 h_j.(W^T x_j) + h_j.(W^T W) h_j.

X must be non-negative (checked with one host read); generated NNDSVD
inits are nudged to 1e-6, as in ``tpunmf``.  No kernel: the products are
``torch.matmul`` (cuBLAS on the card) with TF32 off (``core/precision``),
and the column sums are small PyTorch reductions.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.precision import full_f32
from ..core.sums import LOCAL
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-9


def _column_residual_norms(xsq_cols, wtx, gram_w, h):
    """(n,) residual norms ||x_j - W h_j|| without forming W @ H."""
    quad = torch.sum(h * (gram_w @ h), dim=0)
    cross = torch.sum(h * wtx, dim=0)
    sq = torch.clamp(xsq_cols - 2.0 * cross + quad, min=0.0)
    return torch.sqrt(sq)


def _robust_block(x, xsq_cols, carry, stop_i, tol1, tol2, *, min_iter: int, max_iter: int,
                  verbose=False, sums=LOCAL):
    """Robust NMF iterations up to ``stop_i``.  Over a mesh
    (``parallel.robust_mesh``) ``x`` and the factors are this rank's
    blocks: W^T X, W^T W and ``xsq_cols`` are summed over 'rows' before any
    column norm is read, so every rank of a column block weights its
    columns with the same ``d``; the W half's products are summed over
    'cols', and the l2,1 objective over 'cols'."""
    def step(inner, i):
        w, h = inner
        # weights from the CURRENT iterate's residuals
        gram_w = sums.psum(w.T @ w, "rows")
        wtx = sums.psum(w.T @ x, "rows")
        d = 1.0 / (_column_residual_norms(xsq_cols, wtx, gram_w, h) + _EPS)

        # H update on the reweighted problem (D broadcasts over columns)
        h = h * (wtx * d[None, :]) / (gram_w @ (h * d[None, :]) + _EPS)

        # W update with the fresh H (Gauss-Seidel like reference MUR,
        # nmf/mur.py:122-124)
        hd = h * d[None, :]
        w = w * sums.psum(x @ hd.T, "cols") / (w @ sums.psum(h @ hd.T, "cols") + _EPS)

        gram_w = sums.psum(w.T @ w, "rows")
        wtx = sums.psum(w.T @ x, "rows")
        obj = sums.psum(torch.sum(_column_residual_norms(xsq_cols, wtx, gram_w, h)), "cols")
        return (w, h), obj

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def robust_nmf(
    x,
    k: int,
    *,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    nndsvd_init: tuple = (True, "zero"),
    w_init=None,
    h_init=None,
    key=None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """l2,1-norm robust NMF (Kong-Ding-Huang multiplicative updates).

    Same call/result conventions as :func:`tpunmf_torch.solvers.mur`; the
    objective history records the l2,1 norm (sum of column residual
    norms), not the squared Frobenius norm.  ``key``: ``torch.Generator``
    or int seed for the random init (default 42; torch's draws differ from
    those of jax.random).  X that is a tensor stays on its device; any
    other X goes to the CUDA device (``core/device.as_input``).
    """
    x = as_input(x).contiguous()
    if bool(torch.any(x < 0)):
        raise ValueError("x must be non-negative")
    m, n = x.shape

    with torch.no_grad(), full_f32():
        if w_init is not None or h_init is not None:
            if w_init is None or h_init is None:
                raise ValueError("provide both w_init and h_init or neither")
            w = torch.as_tensor(w_init, dtype=x.dtype, device=x.device)
            h = torch.as_tensor(h_init, dtype=x.dtype, device=x.device)
        elif nndsvd_init[0]:
            w, h = nndsvd(x, k, variant=nndsvd_init[1])
            # multiplicative updates cannot leave zero cells: nudge exact
            # zeros like the beta solver does for its NNDSVD inits
            w = torch.clamp(w, min=1e-6)
            h = torch.clamp(h, min=1e-6)
        else:
            w, h = random_init(key if key is not None else 42, m, n, k, dtype=x.dtype,
                               device=x.device)
        w, h = w.contiguous(), h.contiguous()

        experiment = MurExperiment(
            method="robust", components=k, distance_type="l21",
            nndsvd_init=tuple(nndsvd_init), max_iter=max_iter, tol1=tol1,
            tol2=tol2, lambda_w=0.0, lambda_h=0.0,
        )

        # ||x_j||^2 by one reduction over X's rows (no m x n temporary)
        xsq_cols = torch.linalg.vector_norm(x, dim=0).square()
        obj0 = torch.sum(_column_residual_norms(xsq_cols, w.T @ x, w.T @ w, h))
    carry = init_carry(obj0, max_iter, (w, h))

    def run(c, stop):
        return _robust_block(x, xsq_cols, c, stop, tol1, tol2, min_iter=min_iter,
                             max_iter=max_iter, verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|robust",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)
