"""MUR — Lee-Seung multiplicative update rules, on PyTorch tensors.

Same contract as ``tpunmf.solvers.mur`` (reference: nmf/mur.py:52-146):
update formulas including the regularized KL closed form
``2a / (b + sqrt(b^2 + 4*lambda*a))``, the 1e-9 guards, negative-data
elevation, defaults, convergence semantics and the ``Results`` record.

Routes: ``mur_route`` chooses one per run, from ``use_pallas`` (the name
``tpunmf`` gives the switch; it defaults to True exactly when X is a CUDA
tensor) and X's dtype and rank, before any wrapper is called:

  * single pass (1 pass over X, +1 for the exact objective):
    ``mur_iteration_eu`` / ``mur_iteration_kl`` (ops/mur_fused.py), taken
    exactly where ``tpunmf`` takes it: where ``iter_eu_tileable`` /
    ``iter_kl_tileable`` give X's shape, dtype and rank a strip height
    (tpunmf/solvers/mur.py:403-423).  Where the port's switch
    ``cuda_defaults.mur_single_pass_variant`` says "dma" ("auto" by
    default, as in ``tpunmf``) and ``iter_eu_dma_tileable`` gives a
    strip height, EU takes ``mur_iteration_eu_dma`` (tpunmf/solvers/
    mur.py:413-419).  KL's kernel also returns the objective of the
    incoming iterate, which ``objective="lagged"`` records.
  * fused, the 2-pass pair (2 passes over X, +1 for the exact objective),
    wherever else the update kernels take X and k (float32 or bfloat16,
    k <= 1024): ``mur_w_update`` and ``mur_h_update`` (ops/mur_fused.py)
    and the objective passes ``eu_residual_obj`` / ``kl_obj``
    (ops/fused.py).  With ``objective="lagged"`` (KL) the W pass also
    returns the objective of the incoming iterate and the objective pass
    is dropped: 2 passes, the trace shifted by one iteration.
  * high rank, where the objective kernels take X and k and the update
    kernels do not (1024 < k <= 2048): ``tpunmf``'s jnp step with its
    Pallas ratio and objective passes (tpunmf/solvers/mur.py:242-280),
    ``step_eu`` / ``step_kl`` below with the products in ``torch.matmul``
    and the passes ``kl_ratio``, ``kl_ratio_and_obj`` and
    ``eu_residual_obj`` (ops/fused.py).  bfloat16 X is upcast to float32
    once, at setup (the jnp step promotes it in every product).
    ``objective="lagged"`` runs as 'exact', as in ``tpunmf``.
  * plain (``use_pallas=False``, float64 X, k > 2048): the same
    ``step_eu`` / ``step_kl`` with the plain versions of those passes.
    EU by the Gram trick, KL carrying the ratio from the trailing
    objective pass.
On CUDA the wrappers launch the hand-written kernels; on the CPU they run
their plain versions.

The objective is read to the host once per iteration (solvers/common.py),
so both routes stop at the same iteration as ``tpunmf``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.device import as_input
from ..core.losses import eu_objective_gram
from ..core.precision import full_f32
from ..core.sums import LOCAL
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from ..ops.fused import (eu_residual_obj, eu_residual_obj_ref, kl_obj, kl_ratio,
                         kl_ratio_and_obj, kl_ratio_and_obj_ref, kl_ratio_ref,
                         objective_takes)
from ..ops.mur_fused import (iter_eu_dma_tileable, iter_eu_tileable, iter_kl_tileable,
                             mur_h_update, mur_iteration_eu, mur_iteration_eu_dma,
                             mur_iteration_kl, mur_w_update, updates_take)
from . import cuda_defaults
from .common import (LoopCarry, finalize_history, host_array, init_carry,
                     run_loop, verbose_precision, while_block)

_EPS = 1e-9


def mur_route(x, k: int, distance_type: str, use_pallas: bool = True):
    """(route, strips): the step a run of MUR on X at rank k takes.

    route is 'single', 'pair', 'high_rank' or 'plain' (module docstring);
    strips is the single pass's strip height (EU: bm, or ("dma", bm) for
    the "dma" variant; KL: (bm, bs)) and None on the other routes.  A rule
    of X's dtype, shape and rank, and the port's switch: ``x`` is anything
    with ``.shape``, ``.dtype`` and ``.device`` (a ``meta`` tensor will
    do)."""
    if use_pallas and updates_take(x, k):
        if distance_type != "eu":
            strips = iter_kl_tileable(x, k)
        else:
            strips = iter_eu_tileable(x, k)
            if (strips is not None
                    and cuda_defaults.mur_single_pass_variant(x.device) == "dma"):
                dma_bm = iter_eu_dma_tileable(x, k)
                if dma_bm is not None:
                    strips = ("dma", dma_bm)
        return ("pair", None) if strips is None else ("single", strips)
    if use_pallas and objective_takes(x, k):
        return "high_rank", None
    return "plain", None


def _passes(route: str):
    """(ratio, ratio-and-objective, EU objective) passes of the high-rank
    and plain steps: the kernels' wrappers (tpunmf mur.py:252-253,
    261-277), or on the plain route their plain versions."""
    if route == "plain":
        return kl_ratio_ref, kl_ratio_and_obj_ref, eu_residual_obj_ref
    return kl_ratio, kl_ratio_and_obj, eu_residual_obj


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
    route: str,
    strips=None,
    objective_every: int = 1,
    verbose=False,
    sums=LOCAL,
) -> LoopCarry:
    """Run MUR iterations from ``carry`` up to ``stop_i`` (or convergence).

    ``route`` and ``strips`` are :func:`mur_route`'s.  ``carry.inner`` is
    (w, h) on the kernel-update routes and for EU, and (w, h, r) on the
    high-rank and plain KL routes, r = x / (w h + eps) from the previous
    trailing pass.  On those two routes ``x`` is bfloat16 X upcast to the
    factors' dtype (tpunmf's jnp products promote it the same way).  Over
    a mesh (``parallel.mur_mesh`` on the high-rank and plain routes) ``x``,
    ``r`` and the factors are this rank's blocks and ``sums``
    (core/sums.py) all-reduces the products that contract a split axis,
    the KL closed form's sums and the objective.
    """

    def refresh(i):
        return (i + 1) % objective_every == 0 or i + 1 >= max_iter

    def cadence_obj(i, fn):
        """fn() -> objective; NaN off-cadence (see tpunmf mur.py:96-121)."""
        if objective_every == 1 or refresh(i):
            return fn()
        return torch.tensor(math.nan)

    def step_eu_single(inner, i):
        """Whole iteration in one pass over X (tpunmf mur.py:133-154)."""
        w, h = inner
        if isinstance(strips, tuple):  # ("dma", bm)
            w, wtx, gram_w = mur_iteration_eu_dma(x, w, h, lam_w=lambda_w, bm=strips[1])
        else:
            w, wtx, gram_w = mur_iteration_eu(x, w, h, lam_w=lambda_w, bm=strips)
        h_new = h * wtx / (gram_w @ h + lambda_h * h + _EPS)
        if objective == "gram":
            obj = cadence_obj(i, lambda: eu_objective_gram(xsq, wtx, gram_w, h_new))
        else:
            obj = cadence_obj(i, lambda: eu_residual_obj(x, w, h_new))
        return (w, h_new), obj

    def step_kl_single(inner, i):
        """Whole KL iteration in one pass over X (tpunmf mur.py:156-179):
        the kernel always returns the objective of the incoming iterate,
        which 'lagged' records; other objectives add the exact pass."""
        w, h = inner
        w, wtr, obj_prev = mur_iteration_kl(x, w, h, lam_w=lambda_w,
                                            bm=strips[0], bs=strips[1])
        c = h * wtr
        d = torch.sum(w, dim=0)[:, None]
        h = 2.0 * c / (d + torch.sqrt(d * d + 4.0 * lambda_h * c))
        if objective == "lagged":
            return (w, h), cadence_obj(i, lambda: obj_prev)
        return (w, h), cadence_obj(i, lambda: kl_obj(x, w, h))

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

    ratio, ratio_obj, eu_obj = _passes(route)

    def step_eu(inner, i):
        w, h = inner
        gram_h = sums.psum(h @ h.T, "cols")
        w = w * sums.psum(x @ h.T, "cols") / (w @ gram_h + lambda_w * w + _EPS)
        wtx = sums.psum(w.T @ x, "rows")
        gram_w = sums.psum(w.T @ w, "rows")
        h = h * wtx / (gram_w @ h + lambda_h * h + _EPS)
        if objective == "gram":
            obj = cadence_obj(i, lambda: eu_objective_gram(xsq, wtx, gram_w, h, sums))
        else:
            obj = cadence_obj(i, lambda: sums.psum(eu_obj(x, w, h), "rows", "cols"))
        return (w, h), obj

    def step_kl(inner, i):
        w, h, r = inner
        a = w * sums.psum(r @ h.T, "cols")
        # == row of ones_like(x) @ h.T (nmf/mur.py:26)
        b = sums.psum(torch.sum(h, dim=1), "cols")
        w = 2.0 * a / (b[None, :] + torch.sqrt(b[None, :] ** 2 + 4.0 * lambda_w * a))
        r2 = ratio(x, w, h, eps=_EPS)
        c = h * sums.psum(w.T @ r2, "rows")
        # == column of w.T @ ones_like(x)
        d = sums.psum(torch.sum(w, dim=0), "rows")[:, None]
        h = 2.0 * c / (d + torch.sqrt(d * d + 4.0 * lambda_h * c))
        if objective_every == 1 or refresh(i):
            r, obj = ratio_obj(x, w, h, eps=_EPS)
            obj = sums.psum(obj, "rows", "cols")
        else:
            # off-cadence trailing passes skip the log term (the ratio is
            # still needed by the next W update)
            r, obj = ratio(x, w, h, eps=_EPS), torch.tensor(math.nan)
        return (w, h, r), obj

    steps = {"single": (step_eu_single, step_kl_single),
             "pair": (step_eu_fused, step_kl_fused),
             "high_rank": (step_eu, step_kl), "plain": (step_eu, step_kl)}
    step = steps[route][distance_type == "kl"]
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
        no extra m*n pass) or 'lagged' (the KL pair and single pass: the
        objective of the incoming iterate from the W pass or the single
        pass, so the trace and the convergence stop lag one iteration; the
        high-rank and plain routes take it as 'exact', as tpunmf does).
      objective_every: compute/record the objective only every N-th
        iteration (plus the last possible one); skipped iterations record
        NaN.
      data_dtype: storage dtype for x (e.g. torch.bfloat16; factors stay
        float32).
      use_pallas: kernel routes on/off (default: on for CUDA X); with it
        on, X's dtype and rank choose the route (``mur_route``).
      block_size/on_block_end: blocked execution with a host callback.
    X that is a tensor stays on its device (a CPU tensor runs on the CPU);
    any other X (a numpy array) goes to the CUDA device, float64 as
    float32, and raises without one.  The factors live where X lives.
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    objective_every = int(objective_every)
    if objective_every < 1:
        raise ValueError("objective_every must be >= 1")

    x = as_input(x)
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

        route, strips = mur_route(x, k, distance_type, use_pallas)
        if route in ("high_rank", "plain"):
            # the jnp step's products promote bf16 X; upcast it once here
            x = x.to(factor_dtype)
        if distance_type == "kl":
            if route in ("single", "pair"):
                obj0 = kl_obj(x, w, h)
                inner = (w, h)
            else:  # tpunmf mur.py:430
                r0, obj0 = _passes(route)[1](x, w, h, eps=_EPS)
                inner = (w, h, r0)
        else:
            # on the high-rank step tpunmf's init takes the jnp objective
            # (mur.py:433) and the port its kernel: the same function
            obj0 = _passes(route)[2](x, w, h)
            inner = (w, h)

    carry = init_carry(obj0, max_iter, inner)

    def run(c, stop):
        return _mur_block(
            x, xsq, c, stop, tol1, tol2, float(lambda_w), float(lambda_h),
            distance_type=distance_type, min_iter=min_iter, max_iter=max_iter,
            objective=objective, route=route, strips=strips,
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
