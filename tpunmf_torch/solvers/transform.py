"""Project new data onto a FIXED basis W (NMF inference, 'transform').

Same contract as ``tpunmf.solvers.transform``: given the trained basis W,
encode unseen columns X_new as non-negative coefficients:

    EU:  H* = argmin_{H >= 0} ||X_new - W H||_F^2  (+ lambda ||H||^2)
         — one exact batched NNLS on the normal equations
         (nnls/activeset.py), the same solver that ANLS runs.
    KL:  fixed-W Lee-Seung H-updates (nmf/mur.py:41-45 with W frozen)
         iterated to a relative-change tolerance; ``tpunmf``'s
         ``lax.while_loop`` is a host loop here, one read a step from the
         third on.

``x_new`` decides the device (``core/device.as_input``) and W follows it,
so a numpy W from ``Results`` works against a CUDA or a CPU ``x_new``; W
decides the dtype, as in ``tpunmf``.  All products run with TF32 off.
``transform(w, x_new)`` returns H (k, n_new) on that device; the
reconstruction ``w @ h`` is ``inverse_transform``.
"""
from __future__ import annotations

import torch

from ..core.device import as_input
from ..core.precision import full_f32
from ..nnls import nnls_activeset

_EPS = 1e-9


def transform(w, x_new, *, distance_type: str = "eu", lambda_h: float = 0.0,
              n_iter: int = 200, tol: float = 1e-6, nnls_opts=None):
    """Encode ``x_new`` (m, n_new) against the fixed basis ``w`` (m, k).

    Args:
      distance_type: 'eu' (exact batched NNLS) or 'kl' (fixed-W MUR).
      lambda_h: Tikhonov weight on H (EU: folded into the normal
        equations like ANLS, reference nmf/anls.py:21-22; KL: the
        regularized closed form nmf/mur.py:43-45).
      n_iter / tol: KL-only iteration budget and relative-change stop.
      nnls_opts: EU-only kwargs forwarded to ``nnls_activeset``.

    Returns: H with shape (k, n_new), H >= 0.
    """
    x_new = as_input(x_new)
    w = as_input(w, device=x_new.device)
    x_new = x_new.to(w.dtype)
    if x_new.ndim != 2 or x_new.shape[0] != w.shape[0]:
        raise ValueError(
            f"x_new must be (m={w.shape[0]}, n_new); got {tuple(x_new.shape)}")
    k = w.shape[1]

    with torch.no_grad(), full_f32():
        if distance_type == "eu":
            gram = w.T @ w + (2.0 * lambda_h) * torch.eye(k, dtype=w.dtype, device=w.device)
            return nnls_activeset(gram, w.T @ x_new, **(nnls_opts or {}))

        if distance_type != "kl":
            raise KeyError("Unknown distance type.")

        # fixed-W KL MUR: h <- 2c / (d + sqrt(d^2 + 4 lambda c)) with
        # c = h * (w^T (x / (w h + eps))), d = colsum(w)
        d = torch.sum(w, dim=0)[:, None]
        h = (torch.mean(x_new) / max(k, 1) + _EPS).expand(k, x_new.shape[1]).clone()
        h_prev = torch.zeros_like(h)
        for i in range(n_iter):
            if i >= 2:
                rel = (torch.amax(torch.abs(h - h_prev))
                       / (torch.amax(torch.abs(h_prev)) + _EPS))
                if not bool(rel > tol):
                    break
            r = x_new / (w @ h + _EPS)
            cc = h * (w.T @ r)
            h_prev, h = h, 2.0 * cc / (d + torch.sqrt(d * d + 4.0 * lambda_h * cc))
        return h


def inverse_transform(w, h):
    """Reconstruct data from coefficients: ``w @ h`` (``h`` decides the
    device, and both meet in their promoted dtype)."""
    h = as_input(h)
    w = as_input(w, device=h.device)
    dtype = torch.promote_types(w.dtype, h.dtype)
    with torch.no_grad(), full_f32():
        return w.to(dtype) @ h.to(dtype)
