"""Plain MUR with the KL divergence (Lee and Seung; raleng/nmf nmf/mur.py).

    R = X / (W H + eps),  A = W * (R H^T),  b = row sums of H
    W <- 2A / (b + sqrt(b^2 + 4 lambda_w A))        (A / b at lambda_w = 0)
    R = X / (W H + eps),  C = H * (W^T R),  d = column sums of W
    H <- 2C / (d + sqrt(d^2 + 4 lambda_h C))
    objective: sum of x log(x / wh) (inf and NaN terms zeroed) - x + wh

X's rows are taken in blocks, so that no (m, n) temporary is larger than
a block.  Imports nothing but torch.
"""
from __future__ import annotations

import numpy as np
import torch

from ._prec import F64, exact_products, row_blocks

EPS = 1e-9


def kl_sum(x, wh):
    """sum(x log(x / wh) - x + wh), the x log term's inf and NaN zeroed."""
    v = x * torch.log(x / wh)
    v = torch.where(torch.isinf(v) & (v > 0), torch.zeros_like(v), v)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    return torch.sum(v - x + wh)


def objective(x, w, h, *, mask=None, prec=F64):
    """KL(X, W H), X's rows in blocks."""
    w, h = prec.cast(w), prec.cast(h)
    with torch.no_grad(), exact_products():
        return sum(float(kl_sum(prec.cast(x[b]), prec.mm(w[b], h)))
                   for b in row_blocks(*x.shape))


def run(x, w0, h0, *, iterations, params=None, mask=None, prec=F64):
    """(W, H, objective trace of iterations + 1 values) from (W0, H0)."""
    params = params or {}
    lam_w, lam_h = float(params.get("lambda_w", 0.0)), float(params.get("lambda_h", 0.0))
    m, n = x.shape
    blocks = row_blocks(m, n)
    w, h = prec.cast(w0).clone(), prec.cast(h0).clone()

    with torch.no_grad(), exact_products():
        trace = [objective(x, w, h, prec=prec)]
        for _ in range(iterations):
            bsum = h.sum(dim=1)[None, :]
            w_new = torch.empty_like(w)
            for b in blocks:
                r = prec.cast(x[b]) / (prec.mm(w[b], h) + EPS)
                a = w[b] * prec.mm(r, h.T)
                w_new[b] = 2.0 * a / (bsum + torch.sqrt(bsum * bsum + 4.0 * lam_w * a))
            w = prec.flush(w_new)
            wtr = torch.zeros_like(h)
            for b in blocks:
                r = prec.cast(x[b]) / (prec.mm(w[b], h) + EPS)
                wtr += prec.mm(w[b].T, r)
            c = h * wtr
            d = w.sum(dim=0)[:, None]
            h = prec.flush(2.0 * c / (d + torch.sqrt(d * d + 4.0 * lam_h * c)))
            trace.append(objective(x, w, h, prec=prec))
    return w, h, np.asarray(trace)
