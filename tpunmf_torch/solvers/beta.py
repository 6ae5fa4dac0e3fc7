"""Generalized beta-divergence MUR (Fevotte-Idier), on PyTorch tensors.

Same contract as ``tpunmf.solvers.mur_beta``: beta=0 is Itakura-Saito,
1 KL, 2 Euclidean, any real in between or beyond:

    d_beta(x|y) = x/y - log(x/y) - 1                          (beta = 0)
                  x log(x/y) - x + y                          (beta = 1)
                  (x^b + (b-1) y^b - b x y^(b-1)) / (b(b-1))  (otherwise)

The updates are the majorize-minimize multiplicative rules with the
Fevotte-Idier exponent gamma(beta) (1 on [1, 2], 1/(2-beta) below 1,
1/(beta-1) above 2) applied to the update ratio:

    H <- H * ( W^T((WH)^(beta-2) * X) / (W^T (WH)^(beta-1)) )^gamma

lambda_w / lambda_h are ridge terms added to the denominators.  Each
iteration is four products (with TF32 off) and elementwise powers over the
m x n reconstruction in plain PyTorch, as ``tpunmf`` computes them in XLA
and not in a kernel; the loop is the shared host loop, so checkpoints
and the convergence stop are ``tpunmf``'s.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.precision import full_f32
from ..core.sums import LOCAL
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-9


def beta_divergence(x, wh, beta: float):
    """Elementwise-summed beta-divergence with the package's masking
    (non-finite log terms at x=0 contribute zero, as the KL objective of
    nmf/utils.py:21-26)."""
    if beta == 1.0:
        val = x * torch.log(x / wh)
        val = torch.where(val == float("inf"), torch.zeros_like(val), val)
        val = torch.where(torch.isnan(val), torch.zeros_like(val), val)
        return torch.sum(val - x + wh)
    if beta == 2.0:
        d = x - wh
        return 0.5 * torch.sum(d * d)
    if beta == 0.0:
        r = x / wh
        val = r - torch.log(r) - 1.0
        return torch.sum(torch.where(x > 0, val, torch.zeros_like(val)))
    b = beta
    return torch.sum(
        (x ** b + (b - 1.0) * wh ** b - b * x * wh ** (b - 1.0)) / (b * (b - 1.0)))


def _gamma(beta: float) -> float:
    if beta < 1.0:
        return 1.0 / (2.0 - beta)
    if beta > 2.0:
        return 1.0 / (beta - 1.0)
    return 1.0


def check_init(w, h, beta: float) -> None:
    """Refuse given inits whose reconstruction has a cell <= 0 where beta
    < 1 (negative powers of it would NaN the first update)."""
    if beta < 1.0 and float(torch.min(w @ h)) <= 0.0:
        raise ValueError(
            "beta < 1 needs a strictly positive init reconstruction: "
            "min(w_init @ h_init) <= 0 would raise zero cells to a "
            "negative power and NaN the run. Nudge the inits to a "
            "small positive floor (e.g. torch.clamp(w, min=1e-6)).")


def _mur_beta_block(x, carry, stop_i, tol1, tol2, lambda_w, lambda_h, *,
                    beta: float, min_iter: int, max_iter: int, verbose, sums=LOCAL):
    """Beta-divergence MUR iterations up to ``stop_i``.  Over a mesh
    (``parallel.mur_beta_mesh``) the powers of W H are taken on this rank's
    block (a local product with k whole), the numerators and denominators
    are summed over the axis each contracts, and the divergence's
    partials over both."""
    g = _gamma(beta)

    def ratio_parts(wh):
        # (WH)^(beta-2) * X and (WH)^(beta-1), with the eps guard keeping
        # negative powers finite at wh ~ 0
        whs = wh + _EPS
        return whs ** (beta - 2.0) * x, whs ** (beta - 1.0)

    def step(inner, i):
        w, h = inner
        num, den = ratio_parts(w @ h)
        ratio_w = sums.psum(num @ h.T, "cols") / (sums.psum(den @ h.T, "cols")
                                                  + lambda_w * w + _EPS)
        w = w * (ratio_w ** g if g != 1.0 else ratio_w)
        num, den = ratio_parts(w @ h)
        ratio_h = sums.psum(w.T @ num, "rows") / (sums.psum(w.T @ den, "rows")
                                                  + lambda_h * h + _EPS)
        h = h * (ratio_h ** g if g != 1.0 else ratio_h)
        return (w, h), sums.psum(beta_divergence(x, w @ h, beta), "rows", "cols")

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def mur_beta(
    x,
    k: int,
    *,
    beta: float = 1.0,
    min_iter: int = 100,
    max_iter: int = 100000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    nndsvd_init=(False, "zero"),
    w_init=None,
    h_init=None,
    key=None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """NMF minimizing the beta-divergence (beta=0 Itakura-Saito, 1 KL,
    2 Euclidean, any real in between or beyond).

    Kwargs mirror :func:`tpunmf_torch.solvers.mur` (``key``: a
    ``torch.Generator`` or int seed for the random init).  Itakura-Saito
    (and any beta < 1) needs strictly positive reconstructions: data zeros
    are fine (masked in the objective), generated (NNDSVD) inits are
    nudged to at least 1e-6 when beta < 1, and an explicit
    ``w_init``/``h_init`` whose reconstruction has a cell <= 0 is refused
    up front (negative powers of it would NaN the first update).  X that
    is a tensor stays on its device; other X goes to the CUDA device
    (``core/device.as_input``).
    """
    x = as_input(x)
    beta = float(beta)
    with torch.no_grad(), full_f32():
        x = x + torch.clamp(-torch.min(x), min=0.0)

        dist_tag = {0.0: "is", 1.0: "kl", 2.0: "eu"}.get(beta, f"beta{beta:g}")
        experiment = MurExperiment(
            method="mur", components=k, distance_type=dist_tag,
            nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
            lambda_w=lambda_w, lambda_h=lambda_h,
        )

        if (w_init is None) != (h_init is None):
            raise ValueError("pass both w_init and h_init, or neither")
        if w_init is not None:
            w = torch.as_tensor(w_init, dtype=x.dtype, device=x.device)
            h = torch.as_tensor(h_init, dtype=x.dtype, device=x.device)
            check_init(w, h, beta)
        elif nndsvd_init[0]:
            w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
            if beta < 1.0:
                # zero cells of the init reconstruction would overwhelm the
                # eps guard of the negative powers: nudge as HALS does
                w = torch.clamp(w, min=1e-6)
                h = torch.clamp(h, min=1e-6)
        else:
            w, h = random_init(key, x.shape[0], x.shape[1], k, kind="abs_normal",
                               dtype=x.dtype, device=x.device)
        w, h = w.contiguous(), h.contiguous()
        obj0 = beta_divergence(x, w @ h, beta)
    carry = init_carry(obj0, max_iter, (w, h))

    def run(c, stop):
        return _mur_beta_block(x, c, stop, tol1, tol2, lambda_w, lambda_h, beta=beta,
                               min_iter=min_iter, max_iter=max_iter, verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + f"|beta={beta:g}",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)
