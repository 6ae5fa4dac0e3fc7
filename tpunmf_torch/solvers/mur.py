"""MUR — Lee-Seung multiplicative update rules, on PyTorch tensors.

Same contract as ``tpunmf.solvers.mur`` (reference: nmf/mur.py:52-146):
update formulas including the regularized KL closed form
``2a / (b + sqrt(b^2 + 4*lambda*a))``, the 1e-9 guards, negative-data
elevation, defaults, convergence semantics and the ``Results`` record.

Two routes, chosen by ``use_pallas`` (the name ``tpunmf`` gives the switch;
it defaults to True exactly when X is a CUDA tensor):

  * fused (2 passes over X, +1 for the exact objective): ``mur_w_update``
    and ``mur_h_update`` (ops/mur_fused.py) and the objective passes
    ``eu_residual_obj`` / ``kl_obj`` (ops/fused.py).  With
    ``objective="lagged"`` (KL) the W pass also returns the objective of
    the incoming iterate and the objective pass is dropped: 2 passes, the
    trace shifted by one iteration.  On CUDA these launch the hand-written
    kernels; on the CPU they run their plain versions.
  * plain (``step_eu`` / ``step_kl``): PyTorch products, EU by the Gram
    trick, KL carrying the ratio from the trailing objective pass.

The objective is read to the host once per iteration (solvers/common.py),
so both routes stop at the same iteration as ``tpunmf``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.losses import eu_objective_gram
from ..core.precision import full_f32
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from ..ops.fused import (eu_residual_obj, eu_residual_obj_ref, kl_obj,
                         kl_ratio, kl_ratio_and_obj)
from ..ops.mur_fused import mur_h_update, mur_w_update
from .common import (LoopCarry, finalize_history, host_array, init_carry,
                     run_loop, verbose_precision, while_block)

_EPS = 1e-9


def _mur_block(
    x,
    xsq,
    carry: LoopCarry,
    stop_i,
    tol1,
    tol2,
    lambda_w,
    lambda_h,
    *,
    distance_type: str,
    min_iter: int,
    max_iter: int,
    objective: str,
    use_pallas: bool,
    objective_every: int = 1,
    verbose=False,
) -> LoopCarry:
    """Run MUR iterations from ``carry`` up to ``stop_i`` (or convergence).

    ``carry.inner`` is (w, h) on the fused route and for EU, and (w, h, r)
    on the plain KL route, r = x / (w h + eps) from the previous trailing
    pass.  On the plain route with bfloat16 X, ``x`` is the X upcast to
    the factors' dtype (tpunmf's jnp products promote it the same way).
    """

    def refresh(i):
        return (i + 1) % objective_every == 0 or i + 1 >= max_iter

    def cadence_obj(i, fn):
        """fn() -> objective; NaN off-cadence (see tpunmf mur.py:96-121)."""
        if objective_every == 1 or refresh(i):
            return fn()
        return torch.tensor(math.nan)

    def step_eu_fused(inner, i):
        w, h = inner
        w = mur_w_update(x, w, h, distance_type="eu", lam=lambda_w)
        h_new, wtx = mur_h_update(x, w, h, distance_type="eu", lam=lambda_h)
        if objective == "gram":
            obj = cadence_obj(i, lambda: eu_objective_gram(
                xsq, wtx, w.T @ w, h_new))
        else:
            obj = cadence_obj(i, lambda: eu_residual_obj(x, w, h_new))
        return (w, h_new), obj

    def step_kl_fused(inner, i):
        w, h = inner
        if objective == "lagged":
            # the W pass emits KL of the INCOMING iterate, so the trailing
            # objective pass is dropped and the recorded objective (and the
            # convergence stop) lags one iteration (tpunmf mur.py:199-235);
            # off-cadence iterations run the obj-free W kernel
            if objective_every == 1 or refresh(i):
                w, obj = mur_w_update(x, w, h, distance_type="kl",
                                      lam=lambda_w, with_lagged_obj=True)
            else:
                w = mur_w_update(x, w, h, distance_type="kl", lam=lambda_w)
                obj = torch.tensor(math.nan)
            h, _ = mur_h_update(x, w, h, distance_type="kl", lam=lambda_h)
            return (w, h), obj
        w = mur_w_update(x, w, h, distance_type="kl", lam=lambda_w)
        h, _ = mur_h_update(x, w, h, distance_type="kl", lam=lambda_h)
        return (w, h), cadence_obj(i, lambda: kl_obj(x, w, h))

    def step_eu(inner, i):
        w, h = inner
        gram_h = h @ h.T
        w = w * (x @ h.T) / (w @ gram_h + lambda_w * w + _EPS)
        wtx = w.T @ x
        gram_w = w.T @ w
        h = h * wtx / (gram_w @ h + lambda_h * h + _EPS)
        if objective == "gram":
            obj = cadence_obj(i, lambda: eu_objective_gram(xsq, wtx, gram_w, h))
        else:
            obj = cadence_obj(i, lambda: eu_residual_obj_ref(x, w, h))
        return (w, h), obj

    def step_kl(inner, i):
        w, h, r = inner
        a = w * (r @ h.T)
        b = torch.sum(h, dim=1)  # == row of ones_like(x) @ h.T (nmf/mur.py:26)
        w = 2.0 * a / (b[None, :] + torch.sqrt(b[None, :] ** 2 + 4.0 * lambda_w * a))
        r2 = kl_ratio(x, w, h, eps=_EPS)
        c = h * (w.T @ r2)
        d = torch.sum(w, dim=0)[:, None]  # == column of w.T @ ones_like(x)
        h = 2.0 * c / (d + torch.sqrt(d * d + 4.0 * lambda_h * c))
        if objective_every == 1 or refresh(i):
            r, obj = kl_ratio_and_obj(x, w, h, eps=_EPS)
        else:
            # off-cadence trailing passes skip the log term (the ratio is
            # still needed by the next W update)
            r, obj = kl_ratio(x, w, h, eps=_EPS), torch.tensor(math.nan)
        return (w, h, r), obj

    if use_pallas:
        step = step_kl_fused if distance_type == "kl" else step_eu_fused
    else:
        step = step_kl if distance_type == "kl" else step_eu
    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def mur(
    x,
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
    save_dir: str = "./results/",
    # --- extensions beyond the reference surface ---
    w_init=None,
    h_init=None,
    key=None,
    objective: str = "exact",
    objective_every: int = 1,
    data_dtype=None,
    use_pallas: Optional[bool] = None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """Non-negative matrix factorization via multiplicative update rules.

    Reference-compatible keyword surface (nmf/mur.py:52-53) plus, as in
    ``tpunmf``:
      w_init/h_init: explicit initial factors.
      key: ``torch.Generator`` or int seed for random init (default seed 0;
        torch's draws differ from jax.random's).
      objective: 'exact' (fused residual pass), 'gram' (EU Gram-trick,
        no extra m*n pass) or 'lagged' (fused KL route: the objective of
        the incoming iterate from the W pass, so the trace and the
        convergence stop lag one iteration; other routes take it as
        'exact', as tpunmf does).
      objective_every: compute/record the objective only every N-th
        iteration (plus the last possible one); skipped iterations record
        NaN.
      data_dtype: storage dtype for x (e.g. torch.bfloat16; factors stay
        float32).
      use_pallas: fused kernel route on/off (default: on for CUDA X).
      block_size/on_block_end: blocked execution with a host callback.
    X is a tensor (or array) on the device the run should use; the factors
    live where X lives.
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    objective_every = int(objective_every)
    if objective_every < 1:
        raise ValueError("objective_every must be >= 1")

    x = torch.as_tensor(x)
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"

    experiment = MurExperiment(
        method="mur",
        components=k,
        distance_type=distance_type,
        nndsvd_init=nndsvd_init,
        max_iter=max_iter,
        tol1=tol1,
        tol2=tol2,
        lambda_w=lambda_w,
        lambda_h=lambda_h,
    )

    with torch.no_grad(), full_f32():
        # data elevation for slightly-negative inputs (nmf/mur.py:99-102):
        # max(-min(x), 0) in x's own dtype, on x's device
        x = x + torch.clamp(-torch.min(x), min=0.0)
        if data_dtype is not None:
            x = x.to(data_dtype)
        x = x.contiguous()
        factor_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype

        if (w_init is None) != (h_init is None):
            raise ValueError("pass both w_init and h_init, or neither")
        if w_init is not None:
            w = torch.as_tensor(w_init, dtype=factor_dtype, device=x.device)
            h = torch.as_tensor(h_init, dtype=factor_dtype, device=x.device)
        elif nndsvd_init[0]:
            w, h = nndsvd(x.to(factor_dtype), k, variant=nndsvd_init[1], key=key)
        else:
            w, h = random_init(key, x.shape[0], x.shape[1], k,
                               kind="abs_normal", dtype=factor_dtype,
                               device=x.device)
        # the kernels take row-major factors; an SVD's U (NNDSVD) or a
        # Fortran-ordered w_init keeps its column-major strides otherwise
        w, h = w.contiguous(), h.contiguous()

        if distance_type == "eu" and objective == "gram":
            xf = x.to(torch.float32) if x.dtype == torch.bfloat16 else x
            xsq = torch.sum(xf * xf)
        else:
            xsq = torch.zeros((), dtype=factor_dtype, device=x.device)

        if not use_pallas:
            # the plain route's products promote bf16 X, as jnp's do
            x = x.to(factor_dtype)
        if distance_type == "kl":
            if use_pallas:
                obj0 = kl_obj(x, w, h)
                inner = (w, h)
            else:
                r0, obj0 = kl_ratio_and_obj(x, w, h, eps=_EPS)
                inner = (w, h, r0)
        else:
            obj0 = (eu_residual_obj if use_pallas else eu_residual_obj_ref)(x, w, h)
            inner = (w, h)

    carry = init_carry(obj0, max_iter, inner)

    def run(c, stop):
        return _mur_block(
            x, xsq, c, stop, tol1, tol2, float(lambda_w), float(lambda_h),
            distance_type=distance_type, min_iter=min_iter, max_iter=max_iter,
            objective=objective, use_pallas=use_pallas,
            objective_every=objective_every,
            verbose=verbose_precision(verbose, tol1, tol2),
        )

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment),
    )

    w, h = carry.inner[0], carry.inner[1]
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i,
                   obj_history=obj_history, experiment=experiment)
