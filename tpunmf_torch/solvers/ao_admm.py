"""AO-ADMM — alternating optimization with inner ADMM subproblem solves.

Same contract as ``tpunmf.solvers.ao_admm`` (reference: nmf/ao_admm.py:201-311):
per-subproblem ``rho = trace(W^T W)/k`` (a 0-d tensor, never read to the
host), one Cholesky of ``G + rho*I`` reused on every inner trip
('chol'; 'cg' goes to ``core/linalg.spd_solve``), the inner stop on
relative primal/dual residuals below 1e-2, the KL data-term split
(``admm.kl_data_split``, shared with ADMM), the W subproblem solved on the
transposed problem, ``rho_mode='adaptive'`` and the local-sparsity W update
(``solvers/ao_admm_local.py``), defaults, convergence semantics and the
``Results`` record.

``tpunmf`` runs each inner ADMM loop as a ``lax.while_loop`` that stops
after the trip whose residual test holds (tpunmf/solvers/common.py:49-80).
Here it is a host loop of at most ``admm_iter`` trips that reads that test
to the host once a trip; ``trips`` counts the subproblems and their trips
per side ('h', 'w') for the tests and ``chip_smoke.py``, outside the
results.  The transposed W subproblem takes views (``v.T`` and the KL
split's ``v_aux.T``, ``dual_v.T``): no m x n array is copied, and the
product ``W H_aux`` is formed in V's layout, so the carried ``v_aux`` and
``dual_v`` stay row-major.

Every product runs with TF32 off (``core/precision.full_f32``) on both
routes.  ``use_pallas`` (default: True exactly when V is a CUDA tensor)
selects the objective: the kernels ``eu_residual_obj`` / ``kl_obj``
(ops/fused.py) where they take V and k (float32 V, ``objective_takes``),
else their plain versions.  ``tpunmf`` takes ``kl_ratio_and_obj`` and
discards its m x n ratio; ``kl_obj`` gives that objective bit for bit
without writing the ratio.  The objective does not feed back into the
iterates, so the two routes run the same trajectory.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.linalg import cho_factor, cho_solve
from ..core.losses import distance
from ..core.precision import full_f32
from ..core.sums import LOCAL
from ..core.types import AoAdmmExperiment, Results
from ..init import nndsvd, random_init
from ..ops.fused import (eu_residual_obj, eu_residual_obj_ref, kl_obj, kl_obj_ref,
                         objective_takes)
from ..prox import prox, prox_l1inf_ball
from .admm import _spd_solve, kl_data_split
from .common import (LoopCarry, finalize_history, host_array, init_carry, run_loop,
                     verbose_precision, while_block)

_INNER_TOL = 1e-2


class Trips:
    """Counts of inner-ADMM subproblems (``h_calls``, ``w_calls``: one of
    each an outer iteration) and of their trips (``h``, ``w``), each of
    which reads one flag to the host."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.h_calls = self.h = self.w_calls = self.w = 0

    def as_dict(self):
        return {"h_calls": self.h_calls, "h": self.h, "w_calls": self.w_calls,
                "w": self.w}

    def per_subproblem(self):
        """Trips per H and per W subproblem."""
        return {"h": self.h / max(self.h_calls, 1), "w": self.w / max(self.w_calls, 1)}


trips = Trips()


def _inner_loop(body, state, n_iter: int, side: str):
    """``tpunmf``'s ``inner_loop(body, state, n_iter, 'while')``: at most
    ``n_iter`` trips, stopping after the trip whose flag is true."""
    setattr(trips, side + "_calls", getattr(trips, side + "_calls") + 1)
    for _ in range(n_iter):
        state, done = body(state)
        setattr(trips, side, getattr(trips, side) + 1)
        if bool(done):
            break
    return state


def _chol(g, rho):
    k = g.shape[0]
    return cho_factor(g + rho * torch.eye(k, dtype=g.dtype, device=g.device))


def _subproblem_solve(g, rho, cho, b, method):
    """Inner normal-equation solve: reuse the Cholesky ('chol',
    nmf/ao_admm.py:55-59) or Jacobi-preconditioned CG ('cg')."""
    if method == "chol":
        return cho_solve(cho, b)
    return _spd_solve(g, rho, b, "cg")


def _inner_prox(prox_type, mat_aux, dual, *, rho, lambda_, upper_bound, sums=LOCAL):
    """Prox step of the inner ADMM updates.

    ``l1inf`` / ``l1inf_transpose`` take the self-consistent ball prox
    (``prox_l1inf_ball``) at the ADMM point ``mat_aux - dual``, as
    ``tpunmf`` does (tpunmf/solvers/ao_admm.py:62-84): ``prox()``'s parity
    ``prox_l1inf``, which ADMM keeps, diverges within a few AO-ADMM outer
    iterations once the duals grow.  The row-wise ball sorts along the
    columns, which a mesh splits: it takes the whole rows (``sums.whole``)."""
    if prox_type in ("l1inf", "l1inf_transpose"):
        z = mat_aux - dual
        if prox_type == "l1inf_transpose":
            return prox_l1inf_ball(z.T, rho=rho, lambda_=lambda_,
                                   upper_bound=upper_bound).T
        return sums.whole(lambda z: prox_l1inf_ball(z, rho=rho, lambda_=lambda_,
                                                    upper_bound=upper_bound), "cols", z)
    return prox(prox_type, mat_aux, dual, rho=rho, lambda_=lambda_,
                upper_bound=upper_bound)


def _residual_norms(h, h_prev, h_aux, dual, sums=LOCAL):
    """The stop test's norms ||h - h_aux||, ||h||, ||h - h_prev||, ||dual||.
    Over a mesh they are of the whole factor (``sums``, one all_reduce),
    so every rank takes the same number of trips."""
    return sums.norms((h - h_aux, h, h - h_prev, dual), "cols")


def _stop(norms):
    """Reference terminate() (nmf/ao_admm.py:33-43) on
    :func:`_residual_norms`: relative primal and dual residuals both below
    1e-2.  A zero-norm dual gives inf or NaN, so the test is False, as in
    numpy."""
    r = norms[0] / norms[1]
    s = norms[2] / norms[3]
    return (r < _INNER_TOL) & (s < _INNER_TOL)


def _terminated(h, h_prev, h_aux, dual, sums=LOCAL):
    """The reference's terminate() on the iterates."""
    return _stop(_residual_norms(h, h_prev, h_aux, dual, sums))


def _product_like(v, w, h):
    """``w @ h`` laid out as ``v``: where ``v`` is the transposed view of a
    row-major array, the product of the transposed factors, transposed
    back, so that elementwise passes against ``v`` keep its layout."""
    if v.stride(-1) != 1:
        return (h.T @ w.T).T
    return w @ h


def _admm_ls_update(y, w, h, dual, k, prox_type, admm_iter, lambda_,
                    spd_solver="chol", upper_bound=1.0, *, side="h", sums=LOCAL):
    """Least-squares inner ADMM (nmf/ao_admm.py:46-68): ``W^T Y`` formed
    once, the factor of ``G + rho I`` reused on every trip.  Over a mesh
    ``y``, ``w`` and ``h`` are this rank's blocks of the subproblem's frame
    and ``sums`` all-reduces W^T W and W^T Y over its rows."""
    g = sums.psum(w.T @ w, "rows")
    rho = torch.trace(g) / k
    cho = _chol(g, rho) if spd_solver == "chol" else None
    wty = sums.psum(w.T @ y, "rows")

    def body(state):
        h, dual = state
        h_aux = _subproblem_solve(g, rho, cho, wty + rho * (h + dual), spd_solver)
        h_prev = h
        h = _inner_prox(prox_type, h_aux, dual, rho=rho, lambda_=lambda_,
                        upper_bound=upper_bound, sums=sums)
        dual = dual + h - h_aux
        return (h, dual), _terminated(h, h_prev, h_aux, dual, sums)

    return _inner_loop(body, (h, dual), admm_iter, side)


def _admm_kl_update(v, v_aux, dual_v, w, h, dual_h, k, prox_type, admm_iter,
                    lambda_, spd_solver="chol", upper_bound=1.0, *, side="h", sums=LOCAL):
    """KL inner ADMM with the data-term split (nmf/ao_admm.py:71-101).
    Over a mesh the split's arrays are this rank's block of V's."""
    g = sums.psum(w.T @ w, "rows")
    rho = torch.trace(g) / k
    cho = _chol(g, rho) if spd_solver == "chol" else None

    def body(state):
        h, dual_h, v_aux, dual_v = state
        h_aux = _subproblem_solve(
            g, rho, cho, sums.psum(w.T @ (v_aux + dual_v), "rows") + rho * (h + dual_h),
            spd_solver)
        h_prev = h
        h = _inner_prox(prox_type, h_aux, dual_h, rho=rho, lambda_=lambda_,
                        upper_bound=upper_bound, sums=sums)
        v_aux, dual_v = kl_data_split(v, _product_like(v, w, h_aux), dual_v)
        dual_h = dual_h + h - h_aux
        return (h, dual_h, v_aux, dual_v), _terminated(h, h_prev, h_aux, dual_h, sums)

    return _inner_loop(body, (h, dual_h, v_aux, dual_v), admm_iter, side)


def _ao_admm_block(
    v,
    carry: LoopCarry,
    stop_i,
    tol1,
    tol2,
    lambda_w,
    lambda_h,
    tau,
    eta,
    upper_bound,
    *,
    k: int,
    distance_type: str,
    prox_w: str,
    prox_h: str,
    rho_mode: str,
    local_sparsity: bool,
    spd_solver: str,
    min_iter: int,
    max_iter: int,
    admm_iter: int,
    use_pallas: bool,
    verbose=False,
    sums=LOCAL,
) -> LoopCarry:
    """Run AO-ADMM iterations from ``carry`` up to ``stop_i`` (or
    convergence).  ``carry.inner`` is ``tpunmf``'s tuple: (w, h, dual_w,
    dual_h) for EU, with (v_aux, dual_v) after it for KL; the local-sparsity
    variant (w, h, w_aux, dual_w, dual_h), likewise.  ``use_pallas`` here
    means the objective kernels, which :func:`ao_admm` chooses by V's dtype
    and rank.  Over a mesh (``parallel.ao_admm_mesh``) every array is this
    rank's block and ``sums`` (core/sums.py) all-reduces the products, the
    inner loops' norms and the objective; the W subproblem, on V^T, takes
    ``sums.T``."""
    from .ao_admm_local import (admm_kl_update_adaptive, admm_local_sparsity_update,
                                admm_ls_update_adaptive)

    adaptive = rho_mode == "adaptive"

    def frame(side):
        # the W subproblem runs on V^T: its rows are V's columns
        return sums if side == "h" else sums.T

    def ls_update(y, w, h, dual, ptype, lam, side):
        if adaptive:
            return admm_ls_update_adaptive(y, w, h, dual, k, ptype, admm_iter, lam,
                                           spd_solver, tau, eta, upper_bound, side=side,
                                           sums=frame(side))
        return _admm_ls_update(y, w, h, dual, k, ptype, admm_iter, lam, spd_solver,
                               upper_bound, side=side, sums=frame(side))

    def kl_update(vv, v_aux, dual_v, w, h, dual_h, ptype, lam, side):
        if adaptive:
            return admm_kl_update_adaptive(vv, v_aux, dual_v, w, h, dual_h, k, ptype,
                                           admm_iter, lam, spd_solver, tau, eta,
                                           upper_bound, side=side, sums=frame(side))
        return _admm_kl_update(vv, v_aux, dual_v, w, h, dual_h, k, ptype, admm_iter,
                               lam, spd_solver, upper_bound, side=side, sums=frame(side))

    def local_w_update(w, w_aux, dual_w, h):
        return admm_local_sparsity_update(v, w, w_aux, dual_w, h, k, admm_iter, lambda_w,
                                          upper_bound, adaptive, tau, eta, spd_solver,
                                          sums=sums)

    def objective(w, h):
        # w is a transposed view; the kernels take row-major operands
        w, h = w.contiguous(), h.contiguous()
        if distance_type == "kl":
            part = (kl_obj if use_pallas else kl_obj_ref)(v, w, h)
        else:
            part = (eu_residual_obj if use_pallas else eu_residual_obj_ref)(v, w, h)
        return sums.psum(part, "rows", "cols")

    def step_eu(inner, i):
        w, h, dual_w, dual_h = inner
        h, dual_h = ls_update(v, w, h, dual_h, prox_h, lambda_h, "h")
        wt, dual_wt = ls_update(v.T, h.T, w.T, dual_w.T, prox_w, lambda_w, "w")
        w, dual_w = wt.T, dual_wt.T
        return (w, h, dual_w, dual_h), objective(w, h)

    def step_kl(inner, i):
        w, h, dual_w, dual_h, v_aux, dual_v = inner
        h, dual_h, v_aux, dual_v = kl_update(v, v_aux, dual_v, w, h, dual_h, prox_h,
                                             lambda_h, "h")
        wt, dual_wt, v_auxt, dual_vt = kl_update(v.T, v_aux.T, dual_v.T, h.T, w.T,
                                                 dual_w.T, prox_w, lambda_w, "w")
        w, dual_w, v_aux, dual_v = wt.T, dual_wt.T, v_auxt.T, dual_vt.T
        return (w, h, dual_w, dual_h, v_aux, dual_v), objective(w, h)

    def step_local_eu(inner, i):
        # standard inner ADMM on H, the coupled two-block l1,inf update on W
        # (nmf/ao_admm_local_sparsity.py:368-376)
        w, h, w_aux, dual_w, dual_h = inner
        h, dual_h = ls_update(v, w, h, dual_h, prox_h, lambda_h, "h")
        w, w_aux, dual_w = local_w_update(w, w_aux, dual_w, h)
        return (w, h, w_aux, dual_w, dual_h), objective(w, h)

    def step_local_kl(inner, i):
        # H by the data-split inner ADMM (its own v_aux, dual_v), W by the
        # coupled update (nmf/ao_admm_local_sparsity.py:378-385)
        w, h, w_aux, dual_w, dual_h, v_aux, dual_v = inner
        h, dual_h, v_aux, dual_v = kl_update(v, v_aux, dual_v, w, h, dual_h, prox_h,
                                             lambda_h, "h")
        w, w_aux, dual_w = local_w_update(w, w_aux, dual_w, h)
        return (w, h, w_aux, dual_w, dual_h, v_aux, dual_v), objective(w, h)

    if local_sparsity:
        step = step_local_kl if distance_type == "kl" else step_local_eu
    else:
        step = step_kl if distance_type == "kl" else step_eu
    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def ao_admm(
    v,
    k: int,
    *,
    distance_type: str = "eu",
    reg_w=(0, "nn"),
    reg_h=(0, "l2n"),
    min_iter: int = 10,
    max_iter: int = 100000,
    admm_iter: int = 10,
    tol1: float = 1e-3,
    tol2: float = 1e-3,
    nndsvd_init=(True, "zero"),
    save_dir: str = "./results/",
    # --- extensions beyond the reference surface ---
    rho_mode: str = "fixed",
    rho_tau: float = 2.0,
    rho_eta: float = 10.0,
    upper_bound: float = 1.0,
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
    """AO-ADMM NMF (Huang-Sidiropoulos-Liavas framework).

    Reference-compatible keyword surface (nmf/ao_admm.py:201-203) plus, as
    in ``tpunmf``: ``rho_mode`` ('fixed' | 'adaptive': residual balancing
    inside the inner loops, with ``rho_tau`` and ``rho_eta``),
    ``upper_bound`` (the l1,inf ball's budget), ``spd_solver`` ('chol' |
    'cg', default 'chol'), explicit ``w_init``/``h_init``, ``key``
    (``torch.Generator`` or int seed for random init and randomized SVD;
    torch's draws differ from jax.random's), ``use_pallas`` and blocked
    execution.  ``rho_mode='adaptive'`` with ``reg_w=(lambda, 'l1inf')``
    selects the local-sparsity variant (solvers/ao_admm_local.py).  V that
    is a tensor stays on its device; any other V goes to the CUDA device.
    bfloat16 V raises, as ``tpunmf``'s Cholesky does on the CPU.
    """
    if distance_type not in ("eu", "kl"):
        raise TypeError("Unknown loss function type.")
    if rho_mode not in ("fixed", "adaptive"):
        raise ValueError("rho_mode must be 'fixed' or 'adaptive'")
    # the coupled local-sparsity W update engages for l1inf on W under
    # adaptive rho; l1inf under fixed rho is the plain ball prox
    local_sparsity = rho_mode == "adaptive" and reg_w[1] == "l1inf"
    if spd_solver is None:
        spd_solver = "chol"
    if spd_solver not in ("chol", "cg"):
        raise ValueError("spd_solver must be 'chol' or 'cg'")

    v = as_input(v).contiguous()
    if v.dtype == torch.bfloat16:
        raise NotImplementedError(
            "Unsupported dtype bfloat16: AO-ADMM's Cholesky and NNDSVD take float32 "
            "or float64 V, as in tpunmf")
    if use_pallas is None:
        use_pallas = v.device.type == "cuda"
    kernels = bool(use_pallas) and v.dtype == torch.float32 and objective_takes(v, k)

    experiment = AoAdmmExperiment(
        method="ao_admm",
        components=k,
        distance_type=distance_type,
        nndsvd_init=nndsvd_init,
        min_iter=min_iter,
        max_iter=max_iter,
        admm_iter=admm_iter,
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

        zw, zh = torch.zeros_like(w), torch.zeros_like(h)
        if local_sparsity:
            # w_aux starts at w and the duals at zero; the coupled W update
            # makes its own data split at each entry
            inner = (w, h, w, zw, zh)
        else:
            inner = (w, h, zw, zh)
        if distance_type == "kl":
            inner += (torch.zeros_like(v), torch.zeros_like(v))
        obj0 = distance(v, w @ h, distance_type)
    carry = init_carry(obj0, max_iter, inner)

    def run(c, stop):
        return _ao_admm_block(
            v, c, stop, tol1, tol2, reg_w[0], reg_h[0], rho_tau, rho_eta, upper_bound,
            k=k, distance_type=distance_type, prox_w=reg_w[1], prox_h=reg_h[1],
            rho_mode=rho_mode, local_sparsity=local_sparsity, spd_solver=spd_solver,
            min_iter=min_iter, max_iter=max_iter, admm_iter=admm_iter,
            use_pallas=kernels, verbose=verbose_precision(verbose, tol1, tol2),
        )

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        # rho_mode changes the carried state's meaning but is not part of the
        # Experiment record: tpunmf appends it to the checkpoint tag
        config_tag=repr(experiment) + (
            f"+rho_mode={rho_mode}" if rho_mode != "fixed" else ""),
    )

    w, h = carry.inner[0], carry.inner[1]
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)
