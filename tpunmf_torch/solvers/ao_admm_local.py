"""Local-sparsity AO-ADMM building blocks: the adaptive-rho inner ADMM
updates and the coupled two-block l1,inf W subproblem.

Same functions as ``tpunmf.solvers.ao_admm_local`` (its re-derivation of
the reference's nmf/ao_admm_local_sparsity.py, with its deliberate
repairs):

  * ``balance_rho`` — one residual-balancing step
    (nmf/ao_admm_local_sparsity.py:197-202), optionally clamped to
    ``[lo, hi]``; the scaled dual becomes ``dual * (rho / rho_new)``.
  * ``admm_ls_update_adaptive`` / ``admm_kl_update_adaptive`` — AO-ADMM's
    inner updates (nmf/ao_admm.py:46-101) with that balancing folded into
    each trip.  rho moves every trip, so each trip solves its k x k
    system afresh (``core/linalg.spd_solve``); the KL split's ``dual_v``
    carries a unit penalty and is never rescaled.
  * ``admm_local_sparsity_update`` — the W subproblem with two couplings,
    ``W_aux = W`` (the l1,inf regularizer, penalty rho1 = max(trace/k,
    1e-6)) and ``V_aux = W H`` (the data term, penalty rho2 = 1), with the
    repaired closed form ``V_aux = (V + rho2 (W H + dual_v)) / (1 + rho2)``,
    ``(V_aux, dual_v)`` made afresh at each entry and ``(W_aux, dual_w)``
    warm-started, adaptive moves clamped to x8 around each rho's start,
    and the un-inverted epsilon stop test (eps_abs 1e-6, eps_rel 1e-3).

Every trip reads its stop flag to the host once, as in ``ao_admm.py``.
"""
from __future__ import annotations

import torch

from ..core.linalg import spd_solve
from ..core.sums import LOCAL
from ..prox import prox_l1inf_ball
from .ao_admm import _inner_loop, _inner_prox, _product_like, _residual_norms, _stop
from .admm import _spd_solve, kl_data_split

_EPS_ABS = 1e-6
_EPS_REL = 1e-3
_RHO_CLAMP = 8.0  # trust region around each rho's initial value

def balance_rho(rho, r_norm, s_norm, dual, *, tau, eta, lo=None, hi=None):
    """One residual-balancing step: raise rho (and scale the scaled dual
    down) when the primal residual exceeds ``eta`` times the dual one,
    lower it in the symmetric case; ``lo`` / ``hi`` clamp it.  Returns
    ``(rho_new, dual_rescaled)``."""
    rho_new = torch.where(r_norm > eta * s_norm, rho * tau,
                          torch.where(s_norm > eta * r_norm, rho / tau, rho))
    if lo is not None:
        rho_new = torch.maximum(rho_new, lo)
    if hi is not None:
        rho_new = torch.minimum(rho_new, hi)
    return rho_new, dual * (rho / rho_new)


def admm_ls_update_adaptive(y, w, h, dual, k, prox_type, admm_iter, lambda_,
                            spd_solver, tau, eta, upper_bound=1.0, *, side="h", sums=LOCAL):
    """Least-squares inner ADMM with residual balancing on rho; rho
    restarts at trace(G)/k at each call.  Over a mesh (``sums``) rho moves
    on norms of the whole factor, the same on every rank."""
    g = sums.psum(w.T @ w, "rows")
    rho0 = torch.trace(g) / k
    wty = sums.psum(w.T @ y, "rows")

    def body(state):
        h, dual, rho = state
        h_aux = _spd_solve(g, rho, wty + rho * (h + dual), spd_solver)
        h_prev = h
        h = _inner_prox(prox_type, h_aux, dual, rho=rho, lambda_=lambda_,
                        upper_bound=upper_bound, sums=sums)
        dual = dual + h - h_aux
        # the reference's terminate() (nmf/ao_admm.py:33-43), as in ao_admm.py
        norms = _residual_norms(h, h_prev, h_aux, dual, sums)
        done = _stop(norms)
        # scaled residuals (Boyd §3.3): r = rho (h - h_aux), s = rho (h - h_prev)
        r_norm = rho * norms[0]
        s_norm = rho * norms[2]
        rho, dual = balance_rho(rho, r_norm, s_norm, dual, tau=tau, eta=eta)
        return (h, dual, rho), done

    h, dual, _ = _inner_loop(body, (h, dual, rho0), admm_iter, side)
    return h, dual


def admm_kl_update_adaptive(v, v_aux, dual_v, w, h, dual_h, k, prox_type,
                            admm_iter, lambda_, spd_solver, tau, eta,
                            upper_bound=1.0, *, side="h", sums=LOCAL):
    """KL inner ADMM with the data-term split and adaptive rho; ``dual_v``
    is not rescaled when rho moves."""
    g = sums.psum(w.T @ w, "rows")
    rho0 = torch.trace(g) / k

    def body(state):
        h, dual_h, v_aux, dual_v, rho = state
        h_aux = _spd_solve(g, rho, sums.psum(w.T @ (v_aux + dual_v), "rows")
                           + rho * (h + dual_h), spd_solver)
        h_prev = h
        h = _inner_prox(prox_type, h_aux, dual_h, rho=rho, lambda_=lambda_,
                        upper_bound=upper_bound, sums=sums)
        v_aux, dual_v = kl_data_split(v, _product_like(v, w, h_aux), dual_v)
        dual_h = dual_h + h - h_aux
        norms = _residual_norms(h, h_prev, h_aux, dual_h, sums)
        done = _stop(norms)
        r_norm = rho * norms[0]
        s_norm = rho * norms[2]
        rho, dual_h = balance_rho(rho, r_norm, s_norm, dual_h, tau=tau, eta=eta)
        return (h, dual_h, v_aux, dual_v, rho), done

    h, dual_h, v_aux, dual_v, _ = _inner_loop(
        body, (h, dual_h, v_aux, dual_v, rho0), admm_iter, side)
    return h, dual_h, v_aux, dual_v


def admm_local_sparsity_update(v, w, w_aux, dual_w, h, k, admm_iter, lambda_w,
                               upper_bound, adaptive, tau, eta, spd_solver, sums=LOCAL):
    """The coupled two-block W subproblem with l1,inf local sparsity
    (``tpunmf``'s re-derivation of nmf/ao_admm_local_sparsity.py:110-156).
    Scaled duals are added (``dual += primal - aux``), so the W block
    solves ``W (rho1 I + rho2 H H^T) = rho1 (W_aux - dual_w) + rho2 (V_aux
    - dual_v) H^T``.  Returns ``(w, w_aux, dual_w)``.  Over a mesh
    (``sums``, V's frame) the products over H's columns and the norms are
    all-reduced; the ball prox works along W's rows, which stay whole."""
    g = sums.psum(h @ h.T, "cols")
    keye = torch.eye(k, dtype=g.dtype, device=g.device)
    rho1_0 = torch.clamp(torch.trace(g) / k, min=1e-6)        # regularizer coupling
    rho2_0 = torch.tensor(1.0, dtype=v.dtype, device=v.device)  # data-term coupling
    v_aux = w @ h
    dual_v = torch.zeros_like(v)
    sqrt_w = torch.sqrt(torch.tensor(float(sums.numel(w, "rows")), dtype=v.dtype,
                                     device=v.device))
    sqrt_v = torch.sqrt(torch.tensor(float(sums.numel(v, "rows", "cols")), dtype=v.dtype,
                                     device=v.device))

    def body(state):
        w, w_aux, dual_w, v_aux, dual_v, rho1, rho2 = state
        # W block (:126-129): normal-equation solve, then the nonneg projection
        a = rho1 * keye + rho2 * g
        b = rho1 * (w_aux - dual_w) + sums.psum(rho2 * (v_aux - dual_v) @ h.T, "cols")
        w = spd_solve(a, b.T, method=spd_solver).T
        w = torch.where(w < 0, torch.zeros_like(w), w)

        # W_aux block: the l1,inf ball prox at the fresh iterate W + dual_w
        w_aux_old = w_aux
        w_aux = prox_l1inf_ball(w + dual_w, rho=rho1, lambda_=lambda_w,
                                upper_bound=upper_bound)

        # V_aux block (:135-139, the repaired closed form)
        wh = w @ h
        v_aux_old = v_aux
        v_aux = (v + rho2 * (wh + dual_v)) / (1.0 + rho2)

        # dual ascent (:141-143, duals added)
        dual_w = dual_w + w - w_aux
        dual_v = dual_v + wh - v_aux

        # residuals as update_residuals (:193-195)
        s = rho1 * (w_aux_old - w_aux) + sums.psum(rho2 * (v_aux_old - v_aux) @ h.T, "cols")
        # the norms of W's shape, then of V's, each set in one all_reduce
        # over a mesh (``sums``)
        nr1, ns, nw, nw_aux = sums.norms((rho1 * (w_aux - w), s, w, w_aux), "rows")
        nr2, nwh, nv_aux = sums.norms((rho2 * (v_aux - wh), wh, v_aux), "rows", "cols")

        if adaptive:
            rho1, dual_w = balance_rho(rho1, nr1, ns, dual_w, tau=tau, eta=eta,
                                       lo=rho1_0 / _RHO_CLAMP, hi=rho1_0 * _RHO_CLAMP)
            rho2, dual_v = balance_rho(rho2, nr2, ns, dual_v, tau=tau, eta=eta,
                                       lo=rho2_0 / _RHO_CLAMP, hi=rho2_0 * _RHO_CLAMP)

        # epsilons per update_residuals (:211-216), eps_abs a constant and
        # the break condition un-inverted (:149-152)
        eps_pri1 = sqrt_w * _EPS_ABS + _EPS_REL * torch.maximum(nw, nw_aux)
        eps_pri2 = sqrt_v * _EPS_ABS + _EPS_REL * torch.maximum(nwh, nv_aux)
        eps_dual = sqrt_w * _EPS_ABS + _EPS_REL * sums.norms(
            (rho1 * dual_w + sums.psum(rho2 * dual_v @ h.T, "cols"),), "rows")[0]
        done = (nr1 < eps_pri1) & (nr2 < eps_pri2) & (ns < eps_dual)
        return (w, w_aux, dual_w, v_aux, dual_v, rho1, rho2), done

    w, w_aux, dual_w, _, _, _, _ = _inner_loop(
        body, (w, w_aux, dual_w, v_aux, dual_v, rho1_0, rho2_0), admm_iter, "w")
    return w, w_aux, dual_w
