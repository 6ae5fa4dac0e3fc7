"""Convex NMF — basis vectors constrained to convex combinations of data, on PyTorch.

Same contract as ``tpunmf.solvers.convex_nmf`` (Ding, Li & Jordan,
TPAMI 2010, §IV): ``X ~ (X W) G^T`` with ``W >= 0 (n x k)``, ``G >= 0
(n x k)``, and X MAY BE MIXED-SIGN.  The multiplicative updates (their
eqs. 26-27) run on the Gram K = X^T X, split as ``K = K+ - K-``:

    G <- G * sqrt( (K+ W + G W^T K- W) / (K- W + G W^T K+ W) )
    W <- W * sqrt( (K+ G + K- W G^T G) / (K- G + K+ W G^T G) )

The objective ``||X - X W G^T||_F^2`` is ``tpunmf``'s Gram form
(``Tr K - 2 <G, K W> + <W^T K W, G^T G>``), with ``K`` formed once as
``K+ - K-`` (the bits ``tpunmf`` forms each iteration).  Everything runs
on the (n, n) Gram, so the m axis is touched only to form K and to emit
the basis ``X W``: no kernel route; the products are ``torch.matmul``
with TF32 off (``core/precision``).

The default init draws G = |N(0,1)| + 0.2 from a ``torch.Generator``
(``key``: a generator or an int seed, default 0; torch's draws differ
from ``jax.random``'s) and W = G normalized by column.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.precision import full_f32
from ..core.types import MurExperiment, Results
from ..init.random import make_generator
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-9


def _convex_obj(trk, k_mat, w, g):
    """||X - X W G^T||^2 via the Gram: Tr K - 2 Tr(G^T K W) + ..."""
    kw = k_mat @ w
    cross = torch.sum(g * kw)
    quad = torch.sum((w.T @ kw) * (g.T @ g))
    return trk - 2.0 * cross + quad


def _convex_block(kp, km, k_mat, trk, carry, stop_i, tol1, tol2, *, min_iter: int,
                  max_iter: int, verbose=False):
    def step(inner, i):
        w, g = inner
        kpw = kp @ w
        kmw = km @ w
        g = g * torch.sqrt((kpw + g @ (w.T @ kmw) + _EPS)
                           / (kmw + g @ (w.T @ kpw) + _EPS))
        gtg = g.T @ g
        kpg = kp @ g
        kmg = km @ g
        w = w * torch.sqrt((kpg + km @ (w @ gtg) + _EPS)
                           / (kmg + kp @ (w @ gtg) + _EPS))
        return (w, g), _convex_obj(trk, k_mat, w, g)

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def convex_nmf(
    x,
    k: int,
    *,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    w_init=None,
    g_init=None,
    key=None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """Convex NMF (Ding-Li-Jordan 2010).  X may be mixed-sign.

    Returns ``Results`` with ``w = X @ W`` (the m x k data-convex basis)
    and ``h = G^T`` (k x n), as numpy arrays.  X that is a tensor stays on
    its device; any other X goes to the CUDA device
    (``core/device.as_input``).
    """
    x = as_input(x)
    n = x.shape[1]
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= n; got k={k}, n={n}")

    with torch.no_grad(), full_f32():
        k_full = x.T @ x
        kp = 0.5 * (torch.abs(k_full) + k_full)
        km = 0.5 * (torch.abs(k_full) - k_full)
        trk = torch.trace(k_full)
        del k_full
        k_mat = kp - km

    experiment = MurExperiment(
        method="convex_nmf", components=k, distance_type="eu-convex",
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=0.0, lambda_h=0.0,
    )

    if (w_init is None) != (g_init is None):
        raise ValueError("pass both w_init and g_init, or neither")
    with torch.no_grad(), full_f32():
        if w_init is not None:
            w = torch.as_tensor(w_init, dtype=x.dtype, device=x.device)
            g = torch.as_tensor(g_init, dtype=x.dtype, device=x.device)
            if tuple(w.shape) != (n, k) or tuple(g.shape) != (n, k):
                raise ValueError(f"w_init/g_init must be ({n}, {k})")
        else:
            gen = make_generator(key, x.device)
            # paper §IV-C: cluster-indicator-like init smoothed by +0.2
            g = torch.randn((n, k), generator=gen, dtype=x.dtype, device=gen.device).abs_() + 0.2
            # W = G D^-1: X W begins at the G-weighted column centroids
            w = g / (torch.sum(g, dim=0, keepdim=True) + _EPS)
        obj0 = _convex_obj(trk, k_mat, w, g)

    carry = init_carry(obj0, max_iter, (w, g))

    def run(c, stop):
        return _convex_block(kp, km, k_mat, trk, c, stop, tol1, tol2, min_iter=min_iter,
                             max_iter=max_iter, verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|convex",
    )
    w, g = carry.inner
    i, obj_history = finalize_history(carry)
    with torch.no_grad(), full_f32():
        basis = x @ w
    return Results(w=host_array(basis), h=host_array(g.T), i=i,
                   obj_history=obj_history, experiment=experiment)
