"""Proximal operators, as ``tpunmf.prox.operators`` (reference:
nmf/admm.py:117-213):

  nn     : projection onto the non-negative orthant
  l1n    : l1 shrink-then-project (lasso with non-negativity)
  l2n    : Tikhonov second-difference smoothing + projection (a dense k x k
           solve along the rank axis)
  l1inf  : row-wise l1,inf-ball "local sparsity" water-filling, vectorized
           (sort + cumsum + first-negative index)
  l1inf_transpose : the column-wise variant
  l1inf_ball      : the self-consistent row-wise prox (AO-ADMM local)

``l1inf`` keeps ``tpunmf``'s parity choices: the reference's
``mat_aux + dual`` / ``mat_aux - dual`` sign mix, the inclusive
``val[:index_count+1]`` sum with numpy's clamping slice, and the
transpose variant's ``theta >= 0`` clamp.  ``rho`` may be a 0-d tensor.
"""
from __future__ import annotations

import torch


def _clamp0(x):
    return torch.where(x < 0, torch.zeros_like(x), x)


def prox_nn(mat_aux, dual):
    """Non-negativity projection (nmf/admm.py:126-131)."""
    return _clamp0(mat_aux - dual)


def prox_l1n(mat_aux, dual, *, rho, lambda_):
    """l1 shrinkage then non-negativity projection (nmf/admm.py:133-139)."""
    return _clamp0(mat_aux - dual - lambda_ / rho)


def prox_l2n(mat_aux, dual, *, rho, lambda_):
    """Tikhonov-smoothing prox (nmf/admm.py:141-156): solves
    (1/rho)(lambda T^T T + rho I) X = (mat_aux - dual), T the tridiagonal
    second difference over the leading (rank) axis, then projects."""
    n = mat_aux.shape[0]
    eye = torch.eye(n, dtype=mat_aux.dtype, device=mat_aux.device)
    t = 2.0 * eye - torch.diag(torch.ones(n - 1, dtype=mat_aux.dtype,
                                          device=mat_aux.device), 1) \
        - torch.diag(torch.ones(n - 1, dtype=mat_aux.dtype,
                                device=mat_aux.device), -1)
    a = (lambda_ * (t.T @ t) + rho * eye) / rho
    # solve_ex: a singular or non-finite system gives inf / NaN, as JAX's
    # solve does, where torch.linalg.solve would raise (on CUDA, after a
    # host read)
    return _clamp0(torch.linalg.solve_ex(a, mat_aux - dual)[0])


def _l1inf_rows(mat_aux, dual, *, rho, lambda_, upper_bound, clamp_theta):
    """Row-wise l1,inf water-filling (nmf/admm.py:158-183): a row whose
    shifted positive part fits the l1 budget keeps it; any other row is
    shrunk by the water level theta found from the descending sort."""
    n = mat_aux.shape[1]
    lam_over_rho = lambda_ / rho

    pos = _clamp0(mat_aux + dual - lam_over_rho)
    fits = torch.sum(pos, dim=1, keepdim=True) <= upper_bound

    val = torch.sort(mat_aux - dual, dim=1, descending=True).values
    cums = torch.cumsum(val, dim=1)
    j = torch.arange(1, n + 1, dtype=mat_aux.dtype, device=mat_aux.device)[None, :]
    test = rho * val + lambda_ - (rho / j) * (cums + lam_over_rho - upper_bound)

    neg = test < 0
    any_neg = torch.any(neg, dim=1)
    first = torch.argmax(neg.to(torch.int8), dim=1)  # first True: reference's j-1
    index_count = torch.where(any_neg, first, torch.full_like(first, n + 1))

    # sum of val[:index_count+1] with numpy's clamping slice semantics
    sum_sel = torch.gather(cums, 1, torch.clamp(index_count, 0, n - 1)[:, None])[:, 0]
    ic = torch.clamp(index_count, min=1).to(mat_aux.dtype)
    theta = rho / ic * (sum_sel + lam_over_rho - upper_bound)
    if clamp_theta:
        theta = _clamp0(theta)

    shrink = _clamp0(mat_aux + dual - lam_over_rho - theta[:, None] / rho)
    return torch.where(fits, pos, shrink)


def prox_l1inf(mat_aux, dual, *, rho, lambda_, upper_bound=1.0):
    """Row-wise l1,inf projection, reference-exact semantics."""
    return _l1inf_rows(mat_aux, dual, rho=rho, lambda_=lambda_,
                       upper_bound=upper_bound, clamp_theta=False)


def prox_l1inf_transpose(mat_aux, dual, *, rho, lambda_, upper_bound=1.0):
    """Column-wise l1,inf projection: each column's own dual (tpunmf fixes
    the reference's ``dual[:, 1]``, nmf/admm.py:196) and theta >= 0."""
    return _l1inf_rows(mat_aux.T, dual.T, rho=rho, lambda_=lambda_,
                       upper_bound=upper_bound, clamp_theta=True).T


def prox_l1inf_ball(z, *, rho, lambda_, upper_bound=1.0):
    """Row-wise prox of ``lambda ||x||_1 + i{x >= 0, sum(x) <= ub}`` at
    ``z``: ``max(z - lambda/rho - theta/rho, 0)``, theta putting each
    over-budget row exactly on the l1 ball (tpunmf/prox/operators.py:128)."""
    n = z.shape[1]
    lam = lambda_ / rho

    pos = torch.clamp(z - lam, min=0.0)
    fits = torch.sum(pos, dim=1, keepdim=True) <= upper_bound

    val = torch.sort(z, dim=1, descending=True).values
    cums = torch.cumsum(val, dim=1)
    j = torch.arange(1, n + 1, dtype=z.dtype, device=z.device)[None, :]
    theta_j = (rho * (cums - upper_bound) - j * lambda_) / j
    active = val - lam - theta_j / rho > 0  # true on a prefix
    jstar = torch.clamp(torch.sum(active, dim=1), min=1)
    theta = torch.gather(theta_j, 1, (jstar - 1)[:, None])
    theta = torch.clamp(theta, min=0.0)

    shrink = torch.clamp(z - lam - theta / rho, min=0.0)
    return torch.where(fits, pos, shrink)


def prox(prox_type: str, mat_aux, dual, *, rho=None, lambda_=None, upper_bound=1.0):
    """String-dispatched proximal operator (reference signature,
    nmf/admm.py:117)."""
    if prox_type == "nn":
        return prox_nn(mat_aux, dual)
    if prox_type == "l1n":
        return prox_l1n(mat_aux, dual, rho=rho, lambda_=lambda_)
    if prox_type == "l2n":
        return prox_l2n(mat_aux, dual, rho=rho, lambda_=lambda_)
    if prox_type == "l1inf":
        return prox_l1inf(mat_aux, dual, rho=rho, lambda_=lambda_,
                          upper_bound=upper_bound)
    if prox_type == "l1inf_transpose":
        return prox_l1inf_transpose(mat_aux, dual, rho=rho, lambda_=lambda_,
                                    upper_bound=upper_bound)
    raise TypeError("Unknown prox_type.")
