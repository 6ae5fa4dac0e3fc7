"""NTF — non-negative tensor (CP/PARAFAC) factorization, on PyTorch.

Same contract as ``tpunmf.solvers.ntf``: an N-way non-negative ``X``
(2 <= N <= 20) is approximated by a rank-``k`` CP model

    X[i1..iN]  ~=  sum_r  F1[i1, r] * F2[i2, r] * ... * FN[iN, r],

with every factor ``Fd >= 0``.  Update families: ``update='mur'``
(Euclidean and KL multiplicative updates; with ``mask=``, the masked
tensor-completion rules) and ``update='hals'`` (CP-HALS, Euclidean);
per-mode ridge ``lambdas``; ``normalize`` equilibrates the component
norms across modes after each iteration.  Validations, messages, the
checkpoint tag and the ``NtfResults`` record are ``tpunmf``'s.

MTTKRP and the reconstruction.  ``tpunmf`` writes each as one ``einsum``;
here both are reshapes of X in its stored layout and ``torch.matmul``
(TF32 off), so that no permuted copy of X is made and the Khatri-Rao
matrix is never formed:

  * ``mttkrp(X, F, d)`` for d < N-1: one GEMM of X's rows, as a
    (prod(shape[:-1]), shape[-1]) matrix, against the last factor; then
    each remaining mode after d, the last first, and each mode before d,
    the first first, is summed out against its factor column by column
    (an elementwise product and a sum over an array of 1/shape[-1] of X's
    size times k).  For d = N-1: one GEMM of F0^T against X as a
    (shape[0], prod(shape[1:])) matrix, then the modes between.
  * ``cp_reconstruct(F)``: the Khatri-Rao product of the leading N-1
    factors (prod(shape[:-1]) x k), times the last factor's transpose.

The EU objective is ``tpunmf``'s Gram form, ``0.5 (||X||^2 - 2 <MTTKRP_N,
FN> + sum(o_d Fd^T Fd))``: no reconstruction, so an EU iteration holds no
array of X's size beyond X (in float32 near a fit it cancels ||X||^2
against the cross term, as in ``tpunmf``).  KL and the masked updates
form the model once per mode, as ``tpunmf`` does.

The kernel: CP-HALS's component loop is HALS's Gauss-Seidel sweep in the
transposed frame, so mode d's update is ``gs_sweep(M^T, G, F^T, lam=,
nsweeps=1)^T`` (ops/hals_sweep.py) where ``sweep_takes`` takes X and k
(float32, k <= 1024) and ``use_pallas`` is on (default: X on CUDA), else
its plain version, the column loop of ``tpunmf``'s ``fori_loop``.  The
per-mode ridge strengths are Python floats from ``lambdas`` (rounded
through X's dtype, as ``tpunmf`` stores them), so no iteration reads one
back from the card.

The random init (no ``factors_init``) draws |N(0,1)| * (mean(X)/k +
1e-9)^(1/N) per mode from a ``torch.Generator`` (``key``: a generator or
an int seed, default 42 as ``tpunmf``'s ``PRNGKey(42)``); torch cannot
reproduce ``jax.random``'s draws, so parity runs pass ``factors_init``.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Optional, Sequence

import torch

from ..core.device import as_input
from ..core.losses import kl_elementwise_sum
from ..core.precision import full_f32
from ..init.random import make_generator
from ..ops.hals_sweep import gs_sweep, gs_sweep_ref, sweep_takes
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-9
_HALS_EPS = 1e-16
_MAX_MODES = 20

NtfExperiment = namedtuple(
    "Experiment",
    "method components distance_type update max_iter tol1 tol2 lambdas",
)

NtfResults = namedtuple("NtfResults", "factors i obj_history experiment")


def _axes(n: int) -> int:
    """``tpunmf``'s mode limit (its einsum letters)."""
    if n > _MAX_MODES:
        raise ValueError(f"tensors beyond 20 modes are unsupported (got {n})")
    return n


def mttkrp(x, factors, mode: int):
    """MTTKRP for one mode: ``X_(mode) @ khatri_rao(other factors)``,
    contracted from X's stored layout (module docstring); (shape[mode], k)."""
    ndim = _axes(x.ndim)
    shape = tuple(x.shape)
    last = ndim - 1
    k = factors[last if mode != last else 0].shape[1]
    if mode < last:
        y = x.reshape(-1, shape[last]) @ factors[last]        # (prod(shape[:last]), k)
        for e in range(last - 1, mode, -1):
            y = torch.sum(y.reshape(-1, shape[e], k) * factors[e], dim=1)
        for e in range(mode):
            y = torch.sum(y.reshape(shape[e], -1, k) * factors[e][:, None, :], dim=0)
        return y
    y = factors[0].T @ x.reshape(shape[0], -1)                # (k, prod(shape[1:]))
    for e in range(1, last):
        y = torch.sum(y.reshape(k, shape[e], -1) * factors[e].T[:, :, None], dim=1)
    return y.T


def cp_reconstruct(factors):
    """Materialize the CP model ``sum_r outer(F1[:,r], ..., FN[:,r])``."""
    _axes(len(factors))
    k = factors[0].shape[1]
    lead = factors[0]
    for f in factors[1:-1]:
        lead = (lead[:, None, :] * f[None, :, :]).reshape(-1, k)
    return (lead @ factors[-1].T).reshape(tuple(f.shape[0] for f in factors))


def _gram_except(grams, mode: int):
    """Hadamard product of all per-factor Grams except ``mode``'s."""
    out = None
    for e, g in enumerate(grams):
        if e == mode:
            continue
        out = g if out is None else out * g
    return out


def _normalize_columns(factors):
    """Equilibrate per-component column norms across modes (the
    reconstruction is unchanged up to rounding)."""
    n = len(factors)
    norms = [torch.linalg.norm(f, dim=0) + _HALS_EPS for f in factors]
    total = norms[0]
    for nm in norms[1:]:
        total = total * nm
    target = total ** (1.0 / n)
    return [f * (target / nm)[None, :] for f, nm in zip(factors, norms)]


def _hadamard(grams):
    full = grams[0]
    for g in grams[1:]:
        full = full * g
    return full


def _eu_gram_obj(xsq, m_last, f_last, grams):
    return 0.5 * (xsq - 2.0 * torch.sum(m_last * f_last) + torch.sum(_hadamard(grams)))


def _make_masked_step(x, mask, distance_type: str, lambdas, normalize: bool):
    """Masked MUR steps (tpunmf/solvers/ntf.py:116-160): only observed
    cells drive the fit, the model formed once per mode."""
    ndim = x.ndim
    mx = mask * x

    def eu_step(inner, i):
        factors = list(inner)
        for d in range(ndim):
            xhat = cp_reconstruct(factors)
            numer = mttkrp(mx, factors, d)
            denom = (mttkrp(mask * xhat, factors, d)
                     + lambdas[d] * factors[d] + _EPS)
            factors[d] = factors[d] * (numer / denom)
        resid = mask * (x - cp_reconstruct(factors))
        obj = 0.5 * torch.sum(resid * resid)
        if normalize:
            factors = _normalize_columns(factors)
        return tuple(factors), obj

    def kl_step(inner, i):
        factors = list(inner)
        for d in range(ndim):
            xhat = cp_reconstruct(factors)
            ratio = mask * (x / (xhat + _EPS))
            numer = mttkrp(ratio, factors, d)
            denom = mttkrp(mask, factors, d) + _EPS
            factors[d] = factors[d] * (numer / denom)
        xhat = cp_reconstruct(factors)
        obj = kl_elementwise_sum(mx, mask * xhat)
        if normalize:
            factors = _normalize_columns(factors)
        return tuple(factors), obj

    return eu_step if distance_type == "eu" else kl_step


def _make_step(x, xsq, distance_type: str, update: str, lambdas, normalize: bool,
               sweep):
    ndim = x.ndim

    def eu_step(inner, i):
        factors = list(inner)
        grams = [f.T @ f for f in factors]
        m_last = None
        for d in range(ndim):
            m = mttkrp(x, factors, d)
            g = _gram_except(grams, d)
            if update == "mur":
                denom = factors[d] @ g + lambdas[d] * factors[d] + _EPS
                factors[d] = factors[d] * (m / denom)
            else:  # CP-HALS: one Gauss-Seidel sweep over the components
                factors[d] = sweep(m.T, g, factors[d].T, lam=lambdas[d], nsweeps=1).T
            grams[d] = factors[d].T @ factors[d]
            m_last = m
        # <X, Xhat> = <MTTKRP_last, F_last(new)>; ||Xhat||^2 by the Grams
        obj = _eu_gram_obj(xsq, m_last, factors[ndim - 1], grams)
        if normalize:
            factors = _normalize_columns(factors)
        return tuple(factors), obj

    def kl_step(inner, i):
        factors = list(inner)
        for d in range(ndim):
            xhat = cp_reconstruct(factors)
            ratio = x / (xhat + _EPS)
            numer = mttkrp(ratio, factors, d)
            del xhat, ratio
            # the Khatri-Rao product's column sums: the Hadamard product
            # of the other factors' column sums
            denom = None
            for e in range(ndim):
                if e == d:
                    continue
                s = torch.sum(factors[e], dim=0)
                denom = s if denom is None else denom * s
            factors[d] = factors[d] * (numer / (denom[None, :] + _EPS))
        obj = kl_elementwise_sum(x, cp_reconstruct(factors))
        if normalize:
            factors = _normalize_columns(factors)
        return tuple(factors), obj

    return eu_step if distance_type == "eu" else kl_step


def _ntf_block(x, mask, xsq, lambdas, carry, stop_i, tol1, tol2, *, distance_type: str,
               update: str, normalize: bool, sweep, min_iter: int, max_iter: int,
               verbose=False):
    if mask is None:
        step = _make_step(x, xsq, distance_type, update, lambdas, normalize, sweep)
    else:
        step = _make_masked_step(x, mask, distance_type, lambdas, normalize)
    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def ntf(
    x,
    k: int,
    *,
    distance_type: str = "eu",
    update: str = "mur",
    lambdas: Optional[Sequence[float]] = None,
    mask=None,
    min_iter: int = 10,
    max_iter: int = 500,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    factors_init: Optional[Sequence] = None,
    key=None,
    normalize: bool = True,
    use_pallas: Optional[bool] = None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> NtfResults:
    """Non-negative CP/PARAFAC factorization of an N-way tensor.

    Keyword surface of ``tpunmf.solvers.ntf``: ``distance_type`` 'eu' or
    'kl' (MUR only), ``update`` 'mur' or 'hals', per-mode ridge
    ``lambdas`` (Euclidean only), ``mask`` (non-negative observation
    weights of X's shape, MUR only), ``factors_init`` (mode d of shape
    (x.shape[d], k)), ``key`` (a ``torch.Generator`` or int seed for the
    |N(0,1)| init, default 42), ``normalize``, the loop's tolerances and
    checkpoints.  ``use_pallas``: CP-HALS's sweep kernel on/off (default
    on for CUDA X; it engages for float32 X at k <= 1024).  X that is a
    tensor stays on its device; any other X goes to the CUDA device
    (``core/device.as_input``).

    Returns:
      NtfResults(factors, i, obj_history, experiment), ``factors[d]`` the
      (x.shape[d], k) mode-d factor as a numpy array.
    """
    x = as_input(x).contiguous()
    ndim = x.ndim
    shape = tuple(x.shape)
    if ndim < 2:
        raise ValueError(f"x must be at least 2-way; got shape {shape}")
    if distance_type not in ("eu", "kl"):
        raise ValueError("distance_type must be 'eu' or 'kl'")
    if update not in ("mur", "hals"):
        raise ValueError("update must be 'mur' or 'hals'")
    if distance_type == "kl" and update == "hals":
        raise ValueError("HALS is least-squares only; use update='mur' for KL")
    if bool(torch.any(x < 0)):
        raise ValueError("x must be non-negative")
    if mask is not None:
        if update != "mur":
            raise ValueError("mask= requires update='mur' (masked HALS "
                             "closed forms are not implemented)")
        mask = as_input(mask, dtype=x.dtype, device=x.device)
        if tuple(mask.shape) != shape:
            raise ValueError(f"mask shape {tuple(mask.shape)} != x shape {shape}")
        if bool(torch.any(mask < 0)):
            raise ValueError("mask must be non-negative")
        mask = mask.contiguous()

    # the strengths as tpunmf keeps them: rounded through X's dtype
    if lambdas is None:
        lam = [0.0] * ndim
    else:
        if len(lambdas) != ndim:
            raise ValueError(f"lambdas must have length {ndim}")
        lam = torch.tensor([float(v) for v in lambdas], dtype=x.dtype).tolist()
        if distance_type == "kl" and any(v != 0 for v in lam):
            raise ValueError("lambdas are Euclidean-only (KL MUR here is "
                             "unregularized)")

    with torch.no_grad(), full_f32():
        if factors_init is not None:
            if len(factors_init) != ndim:
                raise ValueError(f"factors_init must have length {ndim}")
            factors = []
            for d, f in enumerate(factors_init):
                f = torch.as_tensor(f, dtype=x.dtype, device=x.device)
                if tuple(f.shape) != (shape[d], k):
                    raise ValueError(
                        f"factors_init[{d}] must be {(shape[d], k)}; got {tuple(f.shape)}")
                factors.append(f.contiguous())
            if any(bool(torch.any(f < 0)) for f in factors):
                raise ValueError("factors_init must be non-negative")
        else:
            g = make_generator(key if key is not None else 42, x.device)
            # scale so the rank-k sum matches the data's mean magnitude
            scale = (torch.mean(x) / k + _EPS) ** (1.0 / ndim)
            factors = [torch.randn((shape[d], k), generator=g, dtype=x.dtype,
                                   device=g.device).abs_() * scale for d in range(ndim)]

    experiment = NtfExperiment(
        method="ntf", components=k, distance_type=distance_type,
        update=update, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambdas=tuple(float(v) for v in lam),
    )

    if use_pallas is None:
        use_pallas = x.device.type == "cuda"
    sweep = gs_sweep if bool(use_pallas) and sweep_takes(x, k) else gs_sweep_ref

    with torch.no_grad(), full_f32():
        flat = x.reshape(-1)
        xsq = torch.dot(flat, flat)
        if mask is not None:
            xhat = cp_reconstruct(factors)
            if distance_type == "eu":
                resid = mask * (x - xhat)
                obj0 = 0.5 * torch.sum(resid * resid)
            else:
                obj0 = kl_elementwise_sum(mask * x, mask * xhat)
            del xhat
        elif distance_type == "eu":
            grams = [f.T @ f for f in factors]
            obj0 = _eu_gram_obj(xsq, mttkrp(x, factors, ndim - 1), factors[ndim - 1], grams)
        else:
            obj0 = kl_elementwise_sum(x, cp_reconstruct(factors))

    carry = init_carry(obj0, max_iter, tuple(factors))

    def run(c, stop):
        return _ntf_block(x, mask, xsq, lam, c, stop, tol1, tol2,
                          distance_type=distance_type, update=update, normalize=normalize,
                          sweep=sweep, min_iter=min_iter, max_iter=max_iter,
                          verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        # tpunmf formats the shape as a tuple: a resumed tpunmf file matches
        config_tag=(repr(experiment) + f"|ntf:shape={shape}"
                    + ("|masked" if mask is not None else "")),
    )
    factors = [host_array(f) for f in carry.inner]
    i, obj_history = finalize_history(carry)
    return NtfResults(factors=factors, i=i, obj_history=obj_history,
                      experiment=experiment)
