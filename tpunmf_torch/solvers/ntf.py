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
from ..core.sums import LOCAL
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


def _split(roles, d):
    """The roles of the mesh axes that split mode ``d`` (none on one device)."""
    return () if roles is None or roles[d] is None else (roles[d],)


def _others(roles, d):
    """The roles of the axes that split the modes other than ``d``: what
    mode ``d``'s MTTKRP and the Khatri-Rao sums contract over."""
    return tuple(r for e in range(len(roles or ())) if e != d for r in _split(roles, e))


def _normalize_columns(factors, sums=LOCAL, roles=None):
    """Equilibrate per-component column norms across modes (the
    reconstruction is unchanged up to rounding).  A norm is the square
    root of the column's sum of squares, summed over the axis that splits
    the mode over a mesh."""
    n = len(factors)
    norms = [torch.sqrt(sums.psum(torch.sum(f * f, dim=0), *_split(roles, d))) + _HALS_EPS
             for d, f in enumerate(factors)]
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


def _eu_gram_obj(xsq, m_last, f_last, grams, sums=LOCAL, split=()):
    """The Gram-form EU objective; over a mesh ``xsq``, ``m_last`` and the
    Grams are global and the cross term is summed over ``split``, the
    axes that split the last mode."""
    cross = sums.psum(torch.sum(m_last * f_last), *split)
    return 0.5 * (xsq - 2.0 * cross + torch.sum(_hadamard(grams)))


def _all(roles):
    return tuple(r for r in (roles or ()) if r is not None)


def _make_masked_step(x, mask, distance_type: str, lambdas, normalize: bool, sums=LOCAL,
                      roles=None):
    """Masked MUR steps (tpunmf/solvers/ntf.py:116-160): only observed
    cells drive the fit, the model formed once per mode."""
    ndim = x.ndim
    mx = mask * x

    def eu_step(inner, i):
        factors = list(inner)
        for d in range(ndim):
            xhat = cp_reconstruct(factors)
            numer = sums.psum(mttkrp(mx, factors, d), *_others(roles, d))
            denom = (sums.psum(mttkrp(mask * xhat, factors, d), *_others(roles, d))
                     + lambdas[d] * factors[d] + _EPS)
            factors[d] = factors[d] * (numer / denom)
        resid = mask * (x - cp_reconstruct(factors))
        obj = sums.psum(0.5 * torch.sum(resid * resid), *_all(roles))
        if normalize:
            factors = _normalize_columns(factors, sums, roles)
        return tuple(factors), obj

    def kl_step(inner, i):
        factors = list(inner)
        for d in range(ndim):
            xhat = cp_reconstruct(factors)
            ratio = mask * (x / (xhat + _EPS))
            numer = sums.psum(mttkrp(ratio, factors, d), *_others(roles, d))
            denom = sums.psum(mttkrp(mask, factors, d), *_others(roles, d)) + _EPS
            factors[d] = factors[d] * (numer / denom)
        xhat = cp_reconstruct(factors)
        obj = sums.psum(kl_elementwise_sum(mx, mask * xhat), *_all(roles))
        if normalize:
            factors = _normalize_columns(factors, sums, roles)
        return tuple(factors), obj

    return eu_step if distance_type == "eu" else kl_step


def _make_step(x, xsq, distance_type: str, update: str, lambdas, normalize: bool,
               sweep, sums=LOCAL, roles=None):
    ndim = x.ndim

    def gram(f, d):
        return sums.psum(f.T @ f, *_split(roles, d))

    def eu_step(inner, i):
        factors = list(inner)
        grams = [gram(f, d) for d, f in enumerate(factors)]
        m_last = None
        for d in range(ndim):
            m = sums.psum(mttkrp(x, factors, d), *_others(roles, d))
            g = _gram_except(grams, d)
            if update == "mur":
                denom = factors[d] @ g + lambdas[d] * factors[d] + _EPS
                factors[d] = factors[d] * (m / denom)
            else:  # CP-HALS: one Gauss-Seidel sweep over the components
                factors[d] = sweep(m.T, g, factors[d].T, lam=lambdas[d], nsweeps=1).T
            grams[d] = gram(factors[d], d)
            m_last = m
        # <X, Xhat> = <MTTKRP_last, F_last(new)>; ||Xhat||^2 by the Grams
        obj = _eu_gram_obj(xsq, m_last, factors[ndim - 1], grams, sums,
                           _split(roles, ndim - 1))
        if normalize:
            factors = _normalize_columns(factors, sums, roles)
        return tuple(factors), obj

    def kl_step(inner, i):
        factors = list(inner)
        for d in range(ndim):
            xhat = cp_reconstruct(factors)
            ratio = x / (xhat + _EPS)
            numer = sums.psum(mttkrp(ratio, factors, d), *_others(roles, d))
            del xhat, ratio
            # the Khatri-Rao product's column sums: the Hadamard product
            # of the other factors' column sums
            denom = None
            for e in range(ndim):
                if e == d:
                    continue
                s = sums.psum(torch.sum(factors[e], dim=0), *_split(roles, e))
                denom = s if denom is None else denom * s
            factors[d] = factors[d] * (numer / (denom[None, :] + _EPS))
        obj = sums.psum(kl_elementwise_sum(x, cp_reconstruct(factors)), *_all(roles))
        if normalize:
            factors = _normalize_columns(factors, sums, roles)
        return tuple(factors), obj

    return eu_step if distance_type == "eu" else kl_step


def _initial_objective(x, mask, xsq, factors, distance_type: str, sums=LOCAL, roles=None):
    """The objective of the initial factors, as the steps record theirs."""
    ndim = x.ndim
    if mask is not None:
        xhat = cp_reconstruct(factors)
        if distance_type == "eu":
            resid = mask * (x - xhat)
            obj = 0.5 * torch.sum(resid * resid)
        else:
            obj = kl_elementwise_sum(mask * x, mask * xhat)
        return sums.psum(obj, *_all(roles))
    if distance_type == "eu":
        grams = [sums.psum(f.T @ f, *_split(roles, d)) for d, f in enumerate(factors)]
        m_last = sums.psum(mttkrp(x, factors, ndim - 1), *_others(roles, ndim - 1))
        return _eu_gram_obj(xsq, m_last, factors[ndim - 1], grams, sums,
                            _split(roles, ndim - 1))
    return sums.psum(kl_elementwise_sum(x, cp_reconstruct(factors)), *_all(roles))


def _ntf_block(x, mask, xsq, lambdas, carry, stop_i, tol1, tol2, *, distance_type: str,
               update: str, normalize: bool, sweep, min_iter: int, max_iter: int,
               verbose=False, sums=LOCAL, roles=None):
    """NTF iterations up to ``stop_i``.  Over a mesh (``parallel.ntf_mesh``)
    ``x`` (and ``mask``) are this rank's block, mode ``d``'s factor is
    split over the axis of role ``roles[d]`` (or whole), and ``sums``
    all-reduces each MTTKRP over the axes that split the other modes, each
    Gram and column sum over its own mode's axis, and the objective."""
    if mask is None:
        step = _make_step(x, xsq, distance_type, update, lambdas, normalize, sweep, sums,
                          roles)
    else:
        step = _make_masked_step(x, mask, distance_type, lambdas, normalize, sums, roles)
    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def check_options(shape, distance_type: str, update: str) -> None:
    """``tpunmf``'s checks of X's order and the update family."""
    if len(shape) < 2:
        raise ValueError(f"x must be at least 2-way; got shape {shape}")
    if distance_type not in ("eu", "kl"):
        raise ValueError("distance_type must be 'eu' or 'kl'")
    if update not in ("mur", "hals"):
        raise ValueError("update must be 'mur' or 'hals'")
    if distance_type == "kl" and update == "hals":
        raise ValueError("HALS is least-squares only; use update='mur' for KL")


def check_mask(mask, shape, update: str) -> None:
    """``mask=``'s checks but its sign (which reads its values)."""
    if update != "mur":
        raise ValueError("mask= requires update='mur' (masked HALS "
                         "closed forms are not implemented)")
    if tuple(mask.shape) != shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != x shape {shape}")


def strengths(lambdas, ndim: int, dtype, distance_type: str) -> list:
    """The per-mode ridge strengths as ``tpunmf`` keeps them: rounded
    through X's dtype, Python floats (no iteration reads one back)."""
    if lambdas is None:
        return [0.0] * ndim
    if len(lambdas) != ndim:
        raise ValueError(f"lambdas must have length {ndim}")
    lam = torch.tensor([float(v) for v in lambdas], dtype=dtype).tolist()
    if distance_type == "kl" and any(v != 0 for v in lam):
        raise ValueError("lambdas are Euclidean-only (KL MUR here is "
                         "unregularized)")
    return lam


def given_factors(factors_init, shape, k: int, as_tensor) -> list:
    """``factors_init`` checked (count, shapes, signs), each through
    ``as_tensor`` and row-major."""
    if len(factors_init) != len(shape):
        raise ValueError(f"factors_init must have length {len(shape)}")
    factors = []
    for d, f in enumerate(factors_init):
        f = as_tensor(f)
        if tuple(f.shape) != (shape[d], k):
            raise ValueError(
                f"factors_init[{d}] must be {(shape[d], k)}; got {tuple(f.shape)}")
        factors.append(f.contiguous())
    if any(bool(torch.any(f < 0)) for f in factors):
        raise ValueError("factors_init must be non-negative")
    return factors


def random_factors(mean, shape, k: int, key, dtype, device) -> list:
    """|N(0, 1)| * (mean(X)/k + 1e-9)^(1/N) a mode, drawn in turn from a
    generator seeded by ``key`` (default 42): the rank-k sum matches the
    data's mean magnitude."""
    g = make_generator(key if key is not None else 42, device)
    scale = (mean / k + _EPS) ** (1.0 / len(shape))
    return [torch.randn((s, k), generator=g, dtype=dtype, device=g.device).abs_() * scale
            for s in shape]


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
    check_options(shape, distance_type, update)
    if bool(torch.any(x < 0)):
        raise ValueError("x must be non-negative")
    if mask is not None:
        check_mask(mask, shape, update)
        mask = as_input(mask, dtype=x.dtype, device=x.device)
        if bool(torch.any(mask < 0)):
            raise ValueError("mask must be non-negative")
        mask = mask.contiguous()
    lam = strengths(lambdas, ndim, x.dtype, distance_type)

    with torch.no_grad(), full_f32():
        if factors_init is not None:
            factors = given_factors(
                factors_init, shape, k,
                lambda f: torch.as_tensor(f, dtype=x.dtype, device=x.device))
        else:
            factors = random_factors(torch.mean(x), shape, k, key, x.dtype, x.device)

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
        obj0 = _initial_objective(x, mask, xsq, factors, distance_type)

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
