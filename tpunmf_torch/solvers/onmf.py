"""Orthogonal NMF — one factor constrained to (near-)orthogonal rows, on PyTorch.

Same contract as ``tpunmf.solvers.onmf``: minimizes ``0.5 ||X - W H||_F^2``
with ``H H^T = I, H >= 0`` (or symmetrically ``W^T W = I``) by the
multiplicative updates of Ding, Li, Peng & Park (SIGKDD 2006, §3):

    W <- W * (X H^T) / (W (H H^T))                (unconstrained half)
    H <- H * sqrt( (W^T X) / ((W^T X H^T) H) )    (orthogonal half)

The denominator is grouped as ``((W^T X) H^T) H``: two k x k-bounded
products instead of the n x n Gram of the textbook ordering.  X is shifted
by ``max(-min(X), 0)``; generated NNDSVD inits are nudged to 1e-6 (the
sqrt update freezes exact zeros); ``orthogonal="w"`` runs the mirror
problem on a row-major copy of X^T (a transposed view would change
cuBLAS's roundings and break the kernels' alignment).  ``obj_history``
records the EU objective, which is not monotone for ONMF; the
orthogonality residual is :func:`orthogonality_residual`.

The products are ``torch.matmul`` with TF32 off (``core/precision``).
``use_pallas`` (default: True exactly when X is a CUDA tensor) picks only
the objective: ``eu_residual_obj`` (ops/fused.py) where
``objective_takes`` takes X and k and X is float32, else its plain
version.  It does not feed back, so both routes give the same factors.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.precision import full_f32
from ..core.sums import LOCAL
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from ..ops.fused import eu_residual_obj, eu_residual_obj_ref, objective_takes
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-9


def orthogonality_residual(h, sums=LOCAL) -> torch.Tensor:
    """||H H^T - diag(H H^T)||_F / ||H H^T||_F (0 = exactly orthogonal).
    Over a mesh ``h`` is this rank's columns and ``sums`` all-reduces the
    Gram, so every rank reads the same residual."""
    h = torch.as_tensor(h)
    with full_f32():
        g = sums.psum(h @ h.T, "cols")
    off = g - torch.diag(torch.diag(g))
    return torch.linalg.norm(off) / (torch.linalg.norm(g) + _EPS)


def _onmf_block(x, carry, stop_i, tol1, tol2, *, objective, min_iter: int, max_iter: int,
                verbose=False, sums=LOCAL):
    """ONMF iterations up to ``stop_i``; over a mesh (``parallel.onmf_mesh``)
    ``x`` and the factors are this rank's blocks and ``sums`` all-reduces
    the products that contract a split axis, and the objective."""
    def step(inner, i):
        w, h = inner
        # unconstrained W half (Lee-Seung EU)
        w = w * sums.psum(x @ h.T, "cols") / (w @ sums.psum(h @ h.T, "cols") + _EPS)
        # orthogonal H half (Ding et al. 2006 eq. 28, transposed frame)
        wtx = sums.psum(w.T @ x, "rows")               # (k, n)
        denom = sums.psum(wtx @ h.T, "cols") @ h + _EPS  # k x k grouping
        h = h * torch.sqrt(wtx / denom)
        return (w, h), sums.psum(objective(x, w, h), "rows", "cols")

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def _transposed(a):
    return None if a is None else torch.as_tensor(a).T


def onmf(
    x,
    k: int,
    *,
    orthogonal: str = "h",
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    nndsvd_init=(False, "zero"),
    w_init=None,
    h_init=None,
    key=None,
    use_pallas: Optional[bool] = None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """Orthogonal NMF (Ding et al. 2006 multiplicative updates).

    Args:
      orthogonal: 'h' constrains H's rows (column clustering, default);
        'w' constrains W's columns (row clustering, via transposition).
      key: ``torch.Generator`` or int seed for the random init (default
        0; torch's draws differ from jax.random's).
      use_pallas: the objective kernel on/off (default: on for CUDA X).

    Returns a ``Results`` record; ``experiment.distance_type`` is tagged
    ``'eu-onmf'``.  Check :func:`orthogonality_residual` on the returned
    factor to monitor the constraint.  X that is a tensor stays on its
    device; any other X goes to the CUDA device (``core/device.as_input``).
    """
    if orthogonal not in ("h", "w"):
        raise ValueError("orthogonal must be 'h' or 'w'")
    if orthogonal == "w":
        res = onmf(as_input(x).T.contiguous(), k, orthogonal="h", min_iter=min_iter,
                   max_iter=max_iter, tol1=tol1, tol2=tol2,
                   nndsvd_init=nndsvd_init, key=key,
                   w_init=_transposed(h_init), h_init=_transposed(w_init),
                   use_pallas=use_pallas, verbose=verbose, block_size=block_size,
                   on_block_end=on_block_end,
                   checkpoint_path=checkpoint_path,
                   checkpoint_every=checkpoint_every, resume=resume)
        return Results(w=res.h.T, h=res.w.T, i=res.i,
                       obj_history=res.obj_history,
                       experiment=res.experiment)

    x = as_input(x)
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"
    kernel = bool(use_pallas) and x.dtype == torch.float32 and objective_takes(x, k)
    objective = eu_residual_obj if kernel else eu_residual_obj_ref

    experiment = MurExperiment(
        method="onmf", components=k, distance_type="eu-onmf",
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=0.0, lambda_h=0.0,
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    with torch.no_grad(), full_f32():
        x = (x + torch.clamp(-torch.min(x), min=0.0)).contiguous()
        if w_init is not None:
            w = torch.as_tensor(w_init, dtype=x.dtype, device=x.device)
            h = torch.as_tensor(h_init, dtype=x.dtype, device=x.device)
        elif nndsvd_init[0]:
            w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
            # the sqrt update freezes exact zeros; nudge generated inits
            w = torch.clamp(w, min=1e-6)
            h = torch.clamp(h, min=1e-6)
        else:
            w, h = random_init(key, x.shape[0], x.shape[1], k, kind="abs_normal",
                               dtype=x.dtype, device=x.device)
        w, h = w.contiguous(), h.contiguous()
        obj0 = objective(x, w, h)
    carry = init_carry(obj0, max_iter, (w, h))

    def run(c, stop):
        return _onmf_block(x, c, stop, tol1, tol2, objective=objective, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|onmf",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)
