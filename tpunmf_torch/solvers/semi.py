"""Semi-NMF (Ding-Li-Jordan 2010), on PyTorch.

Same contract as ``tpunmf.solvers.semi_nmf``: X is MIXED-SIGN and is
factorized as ``W @ H`` with W unconstrained and H >= 0, nothing clamped
or elevated:

    W-update (exact least squares, free sign):
        W = X H^T (H H^T)^{-1}
    H-update (multiplicative, provably monotone for 0.5 exponent):
        H <- H ⊙ sqrt( ((W^T X)^+ + (W^T W)^- H) /
                       ((W^T X)^- + (W^T W)^+ H + eps) )
    with A^+ = (|A| + A)/2, A^- = (|A| - A)/2.

The ridge Gram solve is ``core/linalg.spd_solve('chol')``, NaN where the
Gram is not positive definite, as JAX's ``solve(assume_a="pos")`` is.
The W init solves ``H^T W^T = X^T`` in least squares as
``jnp.linalg.lstsq`` does, from an SVD of H^T with the singular values
below ``eps * max(n, k) * s_max`` dropped (``_lstsq``): the minimum-norm
answer on a rank-deficient H as on a full-rank one, where CUDA's
``torch.linalg.lstsq`` (the ``gels`` driver) assumes full rank.

The products are ``torch.matmul`` with TF32 off (``core/precision``).
``use_pallas`` (default: True exactly when X is a CUDA tensor) picks only
the objective ``0.5 ||X - W H||^2``: ``eu_residual_obj`` (ops/fused.py)
where ``objective_takes`` takes X and k and X is float32, else its plain
version.  It does not feed back, so both routes give the same factors.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.linalg import spd_solve
from ..core.precision import full_f32
from ..core.sums import LOCAL
from ..core.types import MurExperiment, Results
from ..init.random import make_generator
from ..ops.fused import eu_residual_obj, eu_residual_obj_ref, objective_takes
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-9


def _pos(a):
    return (torch.abs(a) + a) * 0.5


def _neg(a):
    return (torch.abs(a) - a) * 0.5


def _lstsq(a, b):
    """The least-squares ``x`` of ``a @ x = b`` as ``jnp.linalg.lstsq``
    gives it: through an SVD of ``a``, singular values below
    ``eps * max(a.shape) * s[0]`` dropped."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    mask = s >= rcond * s[0]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vt.T @ (s_inv[:, None] * (u.T @ b))


def _semi_block(x, carry, stop_i, tol1, tol2, lambda_h, *, objective, min_iter: int,
                max_iter: int, verbose=False, sums=LOCAL):
    """Semi-NMF iterations up to ``stop_i``; over a mesh
    (``parallel.semi_nmf_mesh``) ``x`` and the factors are this rank's
    blocks and ``sums`` (core/sums.py) all-reduces the products and the
    objective; the ridge solve is replicated, the H update local."""
    k = carry.inner[1].shape[0]
    eye = torch.eye(k, dtype=x.dtype, device=x.device)

    def step(inner, i):
        w, h = inner
        # --- W: exact least squares against the current H (free sign);
        # ridge keeps the k x k Gram SPD when H rows are degenerate
        gram_h = sums.psum(h @ h.T, "cols") + 1e-10 * eye
        w = spd_solve(gram_h, sums.psum(x @ h.T, "cols").T).T.contiguous()
        # --- H: split-sign multiplicative update with the sqrt exponent
        wtx = sums.psum(w.T @ x, "rows")
        wtw = sums.psum(w.T @ w, "rows")
        numer = _pos(wtx) + _neg(wtw) @ h
        denom = _neg(wtx) + _pos(wtw) @ h + lambda_h * h + _EPS
        h = h * torch.sqrt(numer / denom)
        return (w, h), sums.psum(objective(x, w, h), "rows", "cols")

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def semi_nmf(
    x,
    k: int,
    *,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_h: float = 0.0,
    w_init=None,
    h_init=None,
    key=None,
    use_pallas: Optional[bool] = None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """Semi-NMF: ``x ~ w @ h`` with w FREE-SIGN and h >= 0.

    Accepts mixed-sign data directly (no elevation).  ``lambda_h`` adds a
    Tikhonov term on H's update denominator.  Init defaults to random: h
    from |N(0,1)| drawn from ``key`` (``torch.Generator`` or int seed,
    default 0; torch's draws differ from jax.random's) and w from one
    exact LS solve against it.  ``use_pallas``: the objective kernel on/off
    (default: on for CUDA X).  X that is a tensor stays on its device; any
    other X goes to the CUDA device (``core/device.as_input``).
    """
    x = as_input(x).contiguous()
    n = x.shape[1]
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"
    kernel = bool(use_pallas) and x.dtype == torch.float32 and objective_takes(x, k)
    objective = eu_residual_obj if kernel else eu_residual_obj_ref

    experiment = MurExperiment(
        method="semi_nmf", components=k, distance_type="eu",
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=0.0, lambda_h=lambda_h,
    )

    if (w_init is None) != (h_init is None) and w_init is not None:
        raise ValueError("pass h_init when passing w_init")
    with torch.no_grad(), full_f32():
        if h_init is not None:
            h = torch.as_tensor(h_init, dtype=x.dtype, device=x.device)
        else:
            g = make_generator(key, x.device)
            h = torch.randn((k, n), generator=g, dtype=x.dtype, device=g.device).abs_()
        h = h.contiguous()
        w = (torch.as_tensor(w_init, dtype=x.dtype, device=x.device) if w_init is not None
             else _lstsq(h.T, x.T).T).contiguous()
        obj0 = objective(x, w, h)
    carry = init_carry(obj0, max_iter, (w, h))

    def run(c, stop):
        return _semi_block(x, c, stop, tol1, tol2, lambda_h, objective=objective,
                           min_iter=min_iter, max_iter=max_iter, verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + "|semi",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)
