"""Objective (distance) functions for NMF: Euclidean and Kullback-Leibler.

Semantics match ``tpunmf.core.losses`` and the reference ``distance``
(reference: nmf/utils.py:18-33), including its KL masking: the term
``x * log(x / wh)`` (no eps) is computed first, then ``+inf`` entries are
zeroed (x > 0, wh == 0), then NaN entries are zeroed (x == 0), and only then
is ``- x + wh`` summed in, for every cell.
"""
from __future__ import annotations

import torch

from .sums import LOCAL


def kl_elementwise_sum(x, wh):
    """Masked KL sum matching reference nmf/utils.py:21-26."""
    value = x * torch.log(x / wh)
    value = torch.where(value == float("inf"), torch.zeros_like(value), value)
    value = torch.where(torch.isnan(value), torch.zeros_like(value), value)
    return torch.sum(value - x + wh)


def eu_elementwise_sum(x, wh):
    """Euclidean distance 0.5 * ||x - wh||_F^2 (reference nmf/utils.py:27-29)."""
    d = x - wh
    return 0.5 * torch.sum(d * d)


def distance(x, wh, distance_type: str = "eu"):
    """Objective value for a given reconstruction ``wh``."""
    if distance_type == "kl":
        return kl_elementwise_sum(x, wh)
    if distance_type == "eu":
        return eu_elementwise_sum(x, wh)
    raise KeyError('Distance type unknown: use "kl" or "eu"')


def eu_objective_gram(xsq, wtx, gram_w, h, sums=LOCAL):
    """Euclidean objective without materializing ``w @ h``.

    0.5*||X - WH||^2 = 0.5*(||X||^2 - 2<H, W^T X> + tr((W^T W)(H H^T))).
    ``wtx`` is ``w.T @ x`` (k, n), as the H update already forms it;
    ``gram_w`` is ``w.T @ w`` (k, k).  Over a mesh (``sums``, core/sums.py)
    ``xsq`` and ``gram_w`` are already global, and ``wtx`` and ``h`` are
    this rank's columns: the cross term and H H^T are summed over them.
    """
    cross = sums.psum(torch.sum(h * wtx), "cols")
    gram_h = sums.psum(h @ h.T, "cols")
    quad = torch.sum(gram_w * gram_h)
    return 0.5 * (xsq - 2.0 * cross + quad)
