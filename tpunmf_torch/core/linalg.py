"""Small shared linear algebra: ``spd_solve`` for (k x k SPD) @ X = B.

Same contract as ``tpunmf.core.linalg.spd_solve``, with two methods:
  'chol' — ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``: exact,
           and the default on the CPU and on CUDA alike (a k x k
           factorization is cheap on the card).  A matrix that is not
           positive definite gives NaN, as JAX's Cholesky does, and
           nothing is read to the host.  ``cho_factor`` / ``cho_solve``
           split it, for a factor reused over several right-hand sides.
  'cg'   — Jacobi-preconditioned CG, one (k, k) @ (k, p) product per step,
           ``k + 8`` steps unless ``cg_iters`` is given, with ``tpunmf``'s
           guards against a zero diagonal and zero denominators.
"""
from __future__ import annotations

import math

import torch


def cho_factor(a):
    """The lower Cholesky factor of a (k, k) SPD ``a`` and its status
    (``torch.linalg.cholesky_ex``: nothing is read to the host)."""
    return torch.linalg.cholesky_ex(a)


def cho_solve(cho, b):
    """Solve with :func:`cho_factor`'s output; NaN where it failed."""
    chol, info = cho
    return torch.where(info != 0, math.nan, torch.cholesky_solve(b, chol))


def spd_solve(a, b, *, method: str = "chol", cg_iters: int = 0):
    """Solve a @ x = b with a (k, k) SPD and b (k, p)."""
    if method == "chol":
        return cho_solve(cho_factor(a), b)

    k = a.shape[0]
    iters = cg_iters or (k + 8)
    diag = torch.diagonal(a)[:, None]
    diag = torch.where(diag <= 0.0, torch.ones_like(diag), diag)  # singular-Gram guard

    x = torch.zeros_like(b)
    r = b
    z = r / diag
    p = z
    rz = torch.sum(r * z, dim=0)
    for _ in range(iters):
        ap = a @ p
        denom = torch.sum(p * ap, dim=0)
        alpha = rz / torch.where(denom == 0.0, torch.ones_like(denom), denom)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = r / diag
        rz_new = torch.sum(r * z, dim=0)
        beta = rz_new / torch.where(rz == 0.0, torch.ones_like(rz), rz)
        p = z + beta[None, :] * p
        rz = rz_new
    return x
