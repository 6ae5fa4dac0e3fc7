"""Plain ADMM for NMF with the KL divergence (Huang, Sidiropoulos and
Liavas' full splitting; raleng/nmf nmf/admm.py), fixed rho:

    state: W, H, their copies W~, H~ (start: W0, H0), duals U_W, U_H (0),
           the split V~ of the data term and its dual U_V (both 0)
    R  = V~ + U_V
    H~ = (W~^T W~ + rho I)^-1 (W~^T R + rho (H + U_H))
    W~ = ((H~ H~^T + rho I)^-1 (H~ R^T + rho (W + U_W)^T))^T
    H  = prox_h(H~ - U_H),  W = prox_w(W~ - U_W)      (along the rank axis)
    P  = W~ H~,  t = P - U_V - 1
    V~ = (t + sqrt(t^2 + 4 V)) / 2,  U_V <- U_V + V~ - P
    U_H <- U_H + H - H~,  U_W <- U_W + W - W~
    objective: KL(V, W H), x log(x / wh) terms that are inf or NaN zeroed

prox 'nn' projects onto the non-negative orthant, 'l1n' shrinks by
lambda / rho first, 'l2n' solves (lambda T^T T + rho I) / rho Z = . with
T the second difference along the rank, then projects.  Imports nothing
but torch.
"""
from __future__ import annotations

import numpy as np
import torch

from ._prec import F64, exact_products, row_blocks
from .mur_kl import objective


def prox(kind, a, lam, rho):
    """The proximal step on ``a`` (k, cols): the rank axis leads."""
    if kind == "nn":
        return torch.clamp(a, min=0.0)
    if kind == "l1n":
        return torch.clamp(a - lam / rho, min=0.0)
    if kind == "l2n":
        k = a.shape[0]
        t = (2.0 * torch.eye(k, dtype=a.dtype, device=a.device)
             - torch.diag(torch.ones(k - 1, dtype=a.dtype, device=a.device), 1)
             - torch.diag(torch.ones(k - 1, dtype=a.dtype, device=a.device), -1))
        sys_ = (lam * (t.T @ t) + rho * torch.eye(k, dtype=a.dtype, device=a.device)) / rho
        return torch.clamp(torch.linalg.solve(sys_, a), min=0.0)
    raise ValueError(f"prox {kind!r} is not in this reference")


def run(x, w0, h0, *, iterations, params=None, mask=None, prec=F64):
    """(W, H, objective trace of iterations + 1 values) from (W0, H0)."""
    params = params or {}
    rho = float(params.get("rho", 1.0))
    lam_w, prox_w = params.get("reg_w", (0.0, "nn"))
    lam_h, prox_h = params.get("reg_h", (0.0, "l2n"))
    m, n = x.shape
    blocks = row_blocks(m, n)
    w, h = prec.cast(w0).clone(), prec.cast(h0).clone()
    k = w.shape[1]
    eye = torch.eye(k, dtype=prec.dtype, device=w.device)
    w_aux, h_aux = w.clone(), h.clone()
    dual_w, dual_h = torch.zeros_like(w), torch.zeros_like(h)
    v_aux = torch.zeros((m, n), dtype=prec.dtype, device=w.device)
    dual_v = torch.zeros_like(v_aux)

    with torch.no_grad(), exact_products():
        trace = [objective(x, w, h, prec=prec)]
        for _ in range(iterations):
            wtr = torch.zeros_like(h)
            for b in blocks:
                wtr += prec.mm(w_aux[b].T, v_aux[b] + dual_v[b])
            h_aux = torch.linalg.solve(prec.mm(w_aux.T, w_aux) + rho * eye,
                                       wtr + rho * (h + dual_h))
            hrt = torch.empty((k, m), dtype=prec.dtype, device=w.device)
            for b in blocks:
                hrt[:, b] = prec.mm(h_aux, (v_aux[b] + dual_v[b]).T)
            w_aux = torch.linalg.solve(prec.mm(h_aux, h_aux.T) + rho * eye,
                                       hrt + rho * (w + dual_w).T).T
            h = prox(prox_h, h_aux - dual_h, float(lam_h), rho)
            w = prox(prox_w, (w_aux - dual_w).T, float(lam_w), rho).T
            for b in blocks:
                p = prec.mm(w_aux[b], h_aux)
                t = p - dual_v[b] - 1.0
                v_aux[b] = 0.5 * (t + torch.sqrt(t * t + 4.0 * prec.cast(x[b])))
                dual_v[b] += v_aux[b] - p
            dual_h = dual_h + h - h_aux
            dual_w = dual_w + w - w_aux
            trace.append(objective(x, w, h, prec=prec))
    return w, h, np.asarray(trace)
