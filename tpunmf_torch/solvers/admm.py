"""ADMM — full-splitting alternating direction method of multipliers.

Same contract as ``tpunmf.solvers.admm`` (reference: nmf/admm.py:233-345):
fixed user rho, the auxiliary least-squares updates (nmf/admm.py:216-230),
prox steps on W and H, the KL data-term split with the closed form
``v_aux = 0.5*((v_bar-1) + sqrt((v_bar-1)^2 + 4v))`` (nmf/admm.py:312-313),
dual ascent, ``rho_mode='adaptive'`` residual balancing (rho in the
carried state, the W/H duals rescaled on a change, the v-split dual not),
defaults, convergence semantics and the ``Results`` record.

The k x k normal equations ``(G + rho I) X = B`` go to
``core/linalg.spd_solve``.  ``spd_solver`` defaults to 'chol' on the CPU
and on CUDA alike: ``tpunmf`` picks 'cg' on a TPU only to avoid its slow
triangular-solve lowering (tpunmf/solvers/tpu_defaults.py:119-121), and a
k x k Cholesky is cheap and exact on the card.

The m*n-sized products ``w_aux.T @ v``, ``h_aux @ v.T`` and (KL)
``w_aux @ h_aux`` are ``torch.matmul`` with TF32 off on both routes, as
``tpunmf`` leaves them to XLA.  ``use_pallas`` (default: True exactly when
V is a CUDA tensor) selects the objective: the kernels ``eu_residual_obj``
/ ``kl_ratio_and_obj`` (ops/fused.py; on the CPU their plain versions)
where they take V and k (``objective_takes``; the factors keep V's dtype
and the kernels take float32 factors, so V must be float32), or their
plain versions directly (float64 V, k > 2048).  The objective does not
feed back into the iterates, so the two routes run the same trajectory.
The KL route discards the ratio that ``kl_ratio_and_obj`` writes, as
``tpunmf`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.linalg import spd_solve
from ..core.losses import distance
from ..core.precision import full_f32
from ..core.sums import LOCAL
from ..core.types import AdmmExperiment, Results
from ..init import nndsvd, random_init
from ..ops.fused import (eu_residual_obj, eu_residual_obj_ref, kl_ratio_and_obj,
                         kl_ratio_and_obj_ref, objective_takes)
from ..prox import prox
from .common import (LoopCarry, finalize_history, host_array, init_carry, run_loop,
                     verbose_precision, while_block)


def kl_data_split(v, wh_aux, dual_v):
    """The KL data-term split of ADMM and AO-ADMM (nmf/admm.py:312-315,
    nmf/ao_admm.py:92-97): ``v_aux = 0.5*((v_bar-1) + sqrt((v_bar-1)^2 +
    4v))`` with ``v_bar = wh_aux - dual_v``, and the dual ascent
    ``dual_v + v_aux - wh_aux``.  Returns ``(v_aux, dual_v)``.

    In place on fresh temporaries (each m x n array is 4 GB at BASELINE
    config[3]) with the roundings of those expressions.  The outputs take
    the layout of ``wh_aux`` and ``dual_v``: elementwise ops keep a
    transposed view's layout."""
    t = wh_aux - dual_v
    t -= 1.0
    v_aux = t * t
    v_aux.add_(v, alpha=4.0).sqrt_().add_(t).mul_(0.5)
    del t
    dual_v = dual_v + v_aux
    dual_v -= wh_aux
    return v_aux, dual_v


def prox_split(sums, over: str, prox_type: str, mat_aux, dual, **kw):
    """``prox`` of a (k, n) pair whose columns split over ``over``
    (core/sums.py): the row-wise l1,inf prox sorts along that axis, so it
    takes the whole rows (``sums.whole``); every other prox is local."""
    def fn(a, d):
        return prox(prox_type, a, d, **kw)

    if prox_type == "l1inf":
        return sums.whole(fn, over, mat_aux, dual)
    return fn(mat_aux, dual)


def _spd_solve(g, rho, b, method="chol"):
    """Solve (g + rho*I) x = b; g is k x k PSD."""
    k = g.shape[0]
    return spd_solve(g + rho * torch.eye(k, dtype=g.dtype, device=g.device), b,
                     method=method)


def _admm_block(
    v,
    carry: LoopCarry,
    stop_i,
    tol1,
    tol2,
    lambda_w,
    lambda_h,
    tau,
    mu,
    *,
    distance_type: str,
    prox_w: str,
    prox_h: str,
    rho_mode: str,
    spd_solver: str,
    min_iter: int,
    max_iter: int,
    use_pallas: bool,
    verbose=False,
    sums=LOCAL,
) -> LoopCarry:
    """Run ADMM iterations from ``carry`` up to ``stop_i`` (or convergence).

    ``carry.inner`` is (w, h, w_aux, h_aux, dual_w, dual_h, rho) for EU and
    (w, h, w_aux, h_aux, dual_w, dual_h, v_aux, dual_v, rho) for KL, rho a
    0-d tensor; the carried tensors are never updated in place.
    ``use_pallas`` here means the objective kernels, which :func:`admm`
    chooses by V's dtype and rank.  Over a mesh (``parallel.admm_mesh``)
    every array is this rank's block (W's rows, H's columns, V's block)
    and ``sums`` (core/sums.py) all-reduces the products, the residual
    balance's sums and the objective; the k x k solves are replicated."""

    def balance(rho, w, h, w_aux, h_aux, w_prev, h_prev, duals):
        """Residual balancing: returns (rho_new, rescaled duals)."""
        if rho_mode != "adaptive":
            return rho, duals
        r = torch.sqrt(sums.psum(torch.sum((h - h_aux) ** 2), "cols")
                       + sums.psum(torch.sum((w - w_aux) ** 2), "rows"))
        sres = rho * torch.sqrt(sums.psum(torch.sum((h - h_prev) ** 2), "cols")
                                + sums.psum(torch.sum((w - w_prev) ** 2), "rows"))
        rho_new = torch.where(r > mu * sres, rho * tau,
                              torch.where(sres > mu * r, rho / tau, rho))
        scale = rho / rho_new
        return rho_new, tuple(d * scale for d in duals)

    def objective(w, h):
        # w is a transposed view; the kernels take row-major operands
        w, h = w.contiguous(), h.contiguous()
        if distance_type == "kl":
            fn = kl_ratio_and_obj if use_pallas else kl_ratio_and_obj_ref
            return sums.psum(fn(v, w, h)[1], "rows", "cols")
        fn = eu_residual_obj if use_pallas else eu_residual_obj_ref
        return sums.psum(fn(v, w, h), "rows", "cols")

    def solve_and_prox(rhs_v, w, h, w_aux, dual_w, dual_h, rho):
        """Aux least-squares updates against ``rhs_v`` (V, or the split
        data term), then the prox steps (nmf/admm.py:216-230, 294-306)."""
        h_aux = _spd_solve(sums.psum(w_aux.T @ w_aux, "rows"), rho,
                           sums.psum(w_aux.T @ rhs_v, "rows") + rho * (h + dual_h),
                           spd_solver)
        w_aux = _spd_solve(sums.psum(h_aux @ h_aux.T, "cols"), rho,
                           sums.psum(h_aux @ rhs_v.T, "cols") + rho * (w.T + dual_w.T),
                           spd_solver).T
        h = prox_split(sums, "cols", prox_h, h_aux, dual_h, rho=rho, lambda_=lambda_h)
        w = prox_split(sums, "rows", prox_w, w_aux.T, dual_w.T, rho=rho,
                       lambda_=lambda_w).T
        return w, h, w_aux, h_aux

    def step_eu(inner, i):
        w_prev, h_prev, w_aux, h_aux, dual_w, dual_h, rho = inner
        w, h, w_aux, h_aux = solve_and_prox(v, w_prev, h_prev, w_aux, dual_w,
                                            dual_h, rho)
        # dual ascent (nmf/admm.py:320-321)
        dual_h = dual_h + h - h_aux
        dual_w = dual_w + w - w_aux
        rho, (dual_w, dual_h) = balance(rho, w, h, w_aux, h_aux, w_prev, h_prev,
                                        (dual_w, dual_h))
        return (w, h, w_aux, h_aux, dual_w, dual_h, rho), objective(w, h)

    def step_kl(inner, i):
        w_prev, h_prev, w_aux, h_aux, dual_w, dual_h, v_aux, dual_v, rho = inner
        w, h, w_aux, h_aux = solve_and_prox(v_aux + dual_v, w_prev, h_prev, w_aux,
                                            dual_w, dual_h, rho)
        # KL data-term closed form (nmf/admm.py:312-315)
        wh_aux = w_aux @ h_aux
        v_aux, dual_v = kl_data_split(v, wh_aux, dual_v)
        del wh_aux
        dual_h = dual_h + h - h_aux
        dual_w = dual_w + w - w_aux
        # dual_v is not rescaled: the v-split carries a unit penalty
        rho, (dual_w, dual_h) = balance(rho, w, h, w_aux, h_aux, w_prev, h_prev,
                                        (dual_w, dual_h))
        return ((w, h, w_aux, h_aux, dual_w, dual_h, v_aux, dual_v, rho),
                objective(w, h))

    step = step_kl if distance_type == "kl" else step_eu
    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def admm(
    v,
    k: int,
    *,
    rho: float = 1.0,
    distance_type: str = "eu",
    reg_w=(0, "nn"),
    reg_h=(0, "l2n"),
    min_iter: int = 10,
    max_iter: int = 100000,
    tol1: float = 1e-3,
    tol2: float = 1e-3,
    nndsvd_init=(True, "zero"),
    save_dir: str = "./results/",
    # --- extensions beyond the reference surface ---
    rho_mode: str = "fixed",
    rho_tau: float = 2.0,
    rho_mu: float = 10.0,
    spd_solver=None,
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
    """Full-splitting ADMM NMF (Huang-Sidiropoulos-Liavas framework).

    Reference-compatible keyword surface (nmf/admm.py:233-235) plus, as in
    ``tpunmf``: ``rho_mode`` ('fixed' | 'adaptive', with ``rho_tau`` and
    ``rho_mu``), ``spd_solver`` ('chol' | 'cg', default 'chol'), explicit
    ``w_init``/``h_init``, ``key`` (``torch.Generator`` or int seed for
    random init and randomized SVD; torch's draws differ from
    jax.random's), ``use_pallas`` and blocked execution.  V that is a tensor
    stays on its device; any other V goes to the CUDA device (as in
    :func:`tpunmf_torch.solvers.mur`).
    """
    if distance_type not in ("eu", "kl"):
        raise TypeError("Unknown loss type.")
    if rho_mode not in ("fixed", "adaptive"):
        raise ValueError("rho_mode must be 'fixed' or 'adaptive'")
    if spd_solver is None:
        spd_solver = "chol"
    if spd_solver not in ("chol", "cg"):
        raise ValueError("spd_solver must be 'chol' or 'cg'")

    v = as_input(v).contiguous()
    if use_pallas is None:
        use_pallas = v.device.type == "cuda"
    kernels = bool(use_pallas) and v.dtype == torch.float32 and objective_takes(v, k)

    experiment = AdmmExperiment(
        method="admm",
        components=k,
        rho=rho,
        distance_type=distance_type,
        nndsvd_init=nndsvd_init,
        min_iter=min_iter,
        max_iter=max_iter,
        tol1=tol1,
        tol2=tol2,
        lambda_w=reg_w[0],
        prox_w=reg_w[1],
        lambda_h=reg_h[0],
        prox_h=reg_h[1],
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    with torch.no_grad(), full_f32():
        if w_init is not None:
            w = torch.as_tensor(w_init, dtype=v.dtype, device=v.device)
            h = torch.as_tensor(h_init, dtype=v.dtype, device=v.device)
        elif nndsvd_init[0]:
            w, h = nndsvd(v, k, variant=nndsvd_init[1], key=key)
        else:
            w, h = random_init(key, v.shape[0], v.shape[1], k, kind="abs_normal",
                               dtype=v.dtype, device=v.device)
        # row-major factors, as the mesh solvers place their blocks: cuBLAS
        # rounds by layout, and an SVD's U (NNDSVD) is column-major
        w, h = w.contiguous(), h.contiguous()

        # aux start as copies, duals at zero (nmf/admm.py:26-35); rho is
        # carried in the state so adaptive damping survives blocks
        rho0 = torch.as_tensor(rho, dtype=v.dtype, device=v.device)
        zeros_wh = (torch.zeros_like(w), torch.zeros_like(h))
        if distance_type == "kl":
            inner = (w, h, w, h, *zeros_wh, torch.zeros_like(v), torch.zeros_like(v),
                     rho0)
        else:
            inner = (w, h, w, h, *zeros_wh, rho0)
        obj0 = distance(v, w @ h, distance_type)
    carry = init_carry(obj0, max_iter, inner)

    def run(c, stop):
        return _admm_block(
            v, c, stop, tol1, tol2, reg_w[0], reg_h[0], rho_tau, rho_mu,
            distance_type=distance_type, prox_w=reg_w[1], prox_h=reg_h[1],
            rho_mode=rho_mode, spd_solver=spd_solver, min_iter=min_iter,
            max_iter=max_iter, use_pallas=kernels,
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
    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)
