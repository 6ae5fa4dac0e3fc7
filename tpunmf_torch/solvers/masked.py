"""Masked (weighted) MUR — factorize only the observed cells of X, on PyTorch.

Same contract as ``tpunmf.solvers.masked`` (weighted NMF, Zhang et al.):
with a binary (or weight) mask M the objectives are

    EU:  0.5 * || M * (X - WH) ||_F^2
    KL:  sum over observed cells of  x log(x / wh) - x + wh

and the Lee-Seung updates fold M into their cross-products
(ops/masked_fused.py has the formulas).  Fully unobserved rows and columns
(cold users and items) keep their KL factor entries.  Negative data is
elevated over the observed cells only; NNDSVD runs on the zero-filled
``x * mask``; the config tag is ``"|masked"``.

Two routes, chosen by ``use_pallas`` (default True exactly when X is a
CUDA tensor):

  * kernel route: ``masked_w_update`` / ``masked_h_update``, one pass over
    (X, M) per half-update.  The factors are float32 for bfloat16 X (X's
    dtype otherwise), and a binary mask rides as 1-byte integers, a
    real-valued weight mask in X's dtype (tpunmf/solvers/masked.py:183-198).
    On CUDA these launch the hand-written kernels; on the CPU they run
    their plain versions.
  * plain route: the same formulas as PyTorch products, factors and mask
    in X's dtype.

The objectives are plain PyTorch on both routes, as in ``tpunmf``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.precision import full_f32
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from ..ops.masked_fused import (masked_h_update, masked_h_update_ref,
                                masked_w_update, masked_w_update_ref)
from .common import finalize_history, host_array, init_carry, run_loop, while_block


def _masked_eu_obj(x, mask, w, h):
    d = mask * (x - w @ h)
    return 0.5 * torch.sum(d * d)


def _masked_kl_obj(x, mask, w, h):
    # reference masking semantics (nmf/utils.py:21-26) restricted to the
    # observed cells: unobserved cells contribute nothing at all
    wh = w @ h
    val = x * torch.log(x / wh)
    val = torch.where(val == float("inf"), torch.zeros_like(val), val)
    val = torch.where(torch.isnan(val), torch.zeros_like(val), val)
    return torch.sum(mask * (val - x + wh))


def _mur_masked_block(x, mask, carry, stop_i, tol1, tol2, lambda_w, lambda_h,
                      *, distance_type: str, min_iter: int, max_iter: int,
                      kernels: bool, verbose=False):
    """Run masked MUR iterations from ``carry`` up to ``stop_i``."""
    w_update = masked_w_update if kernels else masked_w_update_ref
    h_update = masked_h_update if kernels else masked_h_update_ref
    objective = _masked_kl_obj if distance_type == "kl" else _masked_eu_obj

    def step(inner, i):
        w, h = inner
        w = w_update(x, mask, w, h, distance_type=distance_type, lam=lambda_w)
        h = h_update(x, mask, w, h, distance_type=distance_type, lam=lambda_h)
        return (w, h), objective(x, mask, w, h)

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def mur_masked(
    x,
    mask,
    k: int,
    *,
    distance_type: str = "kl",
    min_iter: int = 100,
    max_iter: int = 100000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
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
    """Weighted/masked MUR: fit W @ H to the observed cells of x only.

    ``mask`` is an (m, n) tensor or array: a boolean observation indicator
    or non-negative per-cell weights.  Unobserved cells of ``x`` may hold
    any finite filler (0 is conventional).  Other kwargs match
    :func:`tpunmf_torch.solvers.mur` (``key``: a ``torch.Generator`` or int
    seed for the random init); ``use_pallas``: kernel route on/off
    (default on for CUDA X).  ``checkpoint_path`` is not ported yet.
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    x = torch.as_tensor(x)
    if mask is None:
        raise ValueError("mur_masked requires a mask; use mur() without one")
    mask = torch.as_tensor(mask, device=x.device).to(x.dtype)
    if mask.shape != x.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != data shape "
                         f"{tuple(x.shape)}")
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"

    experiment = MurExperiment(
        method="mur", components=k, distance_type=distance_type,
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )

    with torch.no_grad(), full_f32():
        # negative-data elevation over the OBSERVED cells only
        xmin = torch.min(torch.where(mask > 0, x, torch.full_like(x, float("inf"))))
        x = (x + torch.clamp(-xmin, min=0.0)).contiguous()

        if (w_init is None) != (h_init is None):
            raise ValueError("pass both w_init and h_init, or neither")
        if w_init is not None:
            w = torch.as_tensor(w_init, dtype=x.dtype, device=x.device)
            h = torch.as_tensor(h_init, dtype=x.dtype, device=x.device)
        elif nndsvd_init[0]:
            # NNDSVD on the zero-filled observed matrix (the standard choice)
            w, h = nndsvd(x * mask, k, variant=nndsvd_init[1], key=key)
        else:
            w, h = random_init(key, x.shape[0], x.shape[1], k,
                               kind="abs_normal", dtype=x.dtype,
                               device=x.device)

        if use_pallas:
            # the kernels compute float32 factors for bfloat16 X
            if x.dtype == torch.bfloat16:
                w, h = w.float(), h.float()
            # a binary mask is exact in one byte: a quarter of f32's bytes
            # read every pass; a weight mask keeps X's dtype
            if bool(torch.all((mask == 0) | (mask == 1))):
                mask = mask.to(torch.uint8)
        w, h, mask = w.contiguous(), h.contiguous(), mask.contiguous()

        obj0 = (_masked_kl_obj if distance_type == "kl" else _masked_eu_obj)(
            x, mask, w, h)

    carry = init_carry(obj0, max_iter, (w, h))

    def run(c, stop):
        return _mur_masked_block(
            x, mask, c, stop, tol1, tol2, float(lambda_w), float(lambda_h),
            distance_type=distance_type, min_iter=min_iter, max_iter=max_iter,
            kernels=bool(use_pallas), verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|masked",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i,
                   obj_history=obj_history, experiment=experiment)
