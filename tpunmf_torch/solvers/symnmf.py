"""Symmetric NMF — factorize a similarity/affinity matrix as H H^T, on PyTorch.

Same contract as ``tpunmf.solvers.symnmf``: minimizes ``||A - H H^T||_F^2``
with ``H >= 0`` for a symmetric non-negative A by the damped
multiplicative rule of Kuang, Yun & Park ("SymNMF", J. Glob. Optim. 2015,
eq. 9), non-increasing at beta = 1/2:

    H <- H * ( (1 - beta) + beta * (A H) / (H (H^T H)) )

One (n, n) @ (n, k) product and k x k algebra per iteration; the
objective is ``tpunmf``'s Gram form ``||A||^2 - 2 <H, A H> + ||H^T H||^2``.
The products are ``torch.matmul`` with TF32 off (``core/precision``); no
kernel route.  The default init is uniform on [0, sqrt(mean(A)/k)) from a
``torch.Generator`` (``key``: a generator or an int seed, default 0;
torch's draws differ from ``jax.random``'s).
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


def _symnmf_obj(a, asq, h):
    """||A - H H^T||^2 via Grams: ||A||^2 - 2 <H, AH> + ||H^T H||^2."""
    g = h.T @ h
    return asq - 2.0 * torch.sum(h * (a @ h)) + torch.sum(g * g)


def _symnmf_block(a, asq, carry, stop_i, tol1, tol2, beta, *, min_iter: int,
                  max_iter: int, verbose=False):
    def step(inner, i):
        (h,) = inner
        ah = a @ h
        denom = h @ (h.T @ h) + _EPS
        h = h * ((1.0 - beta) + beta * ah / denom)
        return (h,), _symnmf_obj(a, asq, h)

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def symnmf(
    a,
    k: int,
    *,
    beta: float = 0.5,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    h_init=None,
    key=None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """Symmetric NMF ``A ~ H H^T`` (Kuang-Yun-Park damped rule).

    Args:
      a: (n, n) symmetric non-negative similarity matrix (a tensor stays on
        its device; any other input goes to the CUDA device).
      beta: damping in (0, 1]; 1/2 is the provably non-increasing choice.

    Returns ``Results`` with ``w = H`` (n x k) and ``h = H^T`` as numpy
    arrays; cluster labels are ``H.argmax(1)``.
    """
    a = as_input(a).contiguous()
    n = a.shape[0]
    if tuple(a.shape) != (n, n):
        raise ValueError(f"A must be square; got {tuple(a.shape)}")
    if not 0.0 < beta <= 1.0:
        raise ValueError("beta must be in (0, 1]")
    if bool(torch.any(a < 0)):
        raise ValueError("A must be non-negative")

    with torch.no_grad(), full_f32():
        if h_init is not None:
            h = torch.as_tensor(h_init, dtype=a.dtype, device=a.device)
            if tuple(h.shape) != (n, k):
                raise ValueError(f"h_init must be ({n}, {k})")
        else:
            gen = make_generator(key, a.device)
            # Kuang et al. §5 init: uniform on [0, sqrt(mean(A)/k)]
            scale = torch.sqrt(torch.mean(a) / k)
            h = torch.rand((n, k), generator=gen, dtype=a.dtype, device=gen.device) * scale
        h = h.contiguous()
        flat = a.reshape(-1)
        asq = torch.dot(flat, flat)
        obj0 = _symnmf_obj(a, asq, h)

    experiment = MurExperiment(
        method="symnmf", components=k, distance_type="eu-sym",
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=float(beta), lambda_h=0.0,
    )

    carry = init_carry(obj0, max_iter, (h,))

    def run(c, stop):
        return _symnmf_block(a, asq, c, stop, tol1, tol2, float(beta), min_iter=min_iter,
                             max_iter=max_iter, verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + f"|symnmf:beta={beta:g}",
    )
    (h,) = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(h), h=host_array(h.T), i=i,
                   obj_history=obj_history, experiment=experiment)
