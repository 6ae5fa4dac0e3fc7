"""Nonnegative matrix tri-factorization (co-clustering), on PyTorch.

Same contract as ``tpunmf.solvers.nmtf`` (Ding, Li, Peng & Park, SIGKDD
2006, §5): ``X ~ F S G^T`` with ``F (m x kr)``, ``S (kr x kc)``, ``G (n x
kc)`` non-negative and F, G (approximately) column-orthogonal, by the
multiplicative updates (their eqs. 31-33)

    G <- G * sqrt( (X^T F S)   / (G G^T X^T F S) )
    F <- F * sqrt( (X G S^T)   / (F F^T X G S^T) )
    S <- S * sqrt( (F^T X G)   / (F^T F S G^T G) )

with the orthogonality denominators grouped k-first (nothing n x n or
m x m is formed).  X is shifted by ``max(-min X, 0)``.

The default init is theirs: Lloyd's k-means indicators (+0.2) on the rows
and on the columns, and S from the closed form.  It is split in two: the
k distinct seed points are drawn from a ``torch.Generator`` (``key``: a
generator or an int seed, default 0; torch's draws differ from
``jax.random``'s), and Lloyd's iterations (``_kmeans_indicator``) take
those indices, so a test can hand both packages the same seeds.  The
squared distances of every point to every centre, ``tpunmf``'s
(points, k, dims) difference tensor, are formed over chunks of points
(``_KMEANS_CHUNK_BYTES`` of differences at a time) with the same
arithmetic for each element.

The products are ``torch.matmul`` with TF32 off (``core/precision``).
``use_pallas`` (default: True exactly when X is a CUDA tensor) picks only
the objective ``0.5 ||X - F S G^T||^2``: ``eu_residual_obj(X, F, S G^T)``
(ops/fused.py) where ``objective_takes`` takes X and kr and X is float32,
else its plain version.  It does not feed back, so both routes give the
same factors.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.precision import full_f32
from ..core.types import MurExperiment, Results
from ..init.random import make_generator
from ..ops.fused import eu_residual_obj, eu_residual_obj_ref, objective_takes
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-9
_KMEANS_CHUNK_BYTES = 1 << 28


def _seed_points(npts: int, k: int, gen: torch.Generator):
    """k distinct point indices drawn from ``gen``."""
    return torch.randperm(npts, generator=gen, device=gen.device)[:k]


def _sq_distances(xt, centers):
    """(points, k) squared distances, ``sum((xt[:, None] - centers[None])**2,
    axis=2)``, formed over chunks of points."""
    npts, dims = xt.shape
    k = centers.shape[0]
    rows = max(1, _KMEANS_CHUNK_BYTES // max(1, k * dims * xt.element_size()))
    out = torch.empty((npts, k), dtype=xt.dtype, device=xt.device)
    for r in range(0, npts, rows):
        diff = xt[r:r + rows, None, :] - centers[None, :, :]
        out[r:r + rows] = torch.sum(diff.square_(), dim=2)
    return out


def _kmeans_indicator(xt, k: int, idx, iters: int = 20):
    """(points, dims) -> smoothed (points, k) cluster-indicator matrix.

    Lloyd's k-means from the seed points ``xt[idx]`` (``_seed_points``),
    ``iters`` steps, a centre with no point kept where it is; the +0.2
    smoothing is Ding et al.'s."""
    centers = xt[idx]
    for _ in range(iters):
        assign = torch.argmin(_sq_distances(xt, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(xt.dtype)   # (npts, k)
        counts = torch.sum(onehot, dim=0)[:, None]
        sums = onehot.T @ xt
        centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centers)
    assign = torch.argmin(_sq_distances(xt, centers), dim=1)
    return torch.nn.functional.one_hot(assign, k).to(xt.dtype) + 0.2


def _nmtf_block(x, carry, stop_i, tol1, tol2, *, objective, min_iter: int,
                max_iter: int, verbose=False):
    def step(inner, i):
        f, s, g = inner
        # G update (columns)
        n_g = x.T @ (f @ s)                             # (n, kc)
        g = g * torch.sqrt(n_g / (g @ (g.T @ n_g) + _EPS))
        # F update (rows)
        n_f = x @ (g @ s.T)                             # (m, kr)
        f = f * torch.sqrt(n_f / (f @ (f.T @ n_f) + _EPS))
        # S update (core)
        n_s = f.T @ x @ g                               # (kr, kc)
        s = s * torch.sqrt(n_s / ((f.T @ f) @ s @ (g.T @ g) + _EPS))
        return (f, s, g), objective(x, f, s @ g.T)

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def nmtf(
    x,
    k_row: int,
    k_col: int,
    *,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    f_init=None,
    s_init=None,
    g_init=None,
    key=None,
    use_pallas: Optional[bool] = None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
):
    """Bi-orthogonal NMTF (Ding et al. 2006) for co-clustering.

    Returns ``(Results, s)``: ``Results.w`` is F (m x k_row, row
    clusters), ``Results.h`` is G^T (k_col x n, column clusters), and
    ``s`` is the (k_row x k_col) association core, all numpy arrays.
    ``use_pallas``: the objective kernel on/off (default: on for CUDA X).
    X that is a tensor stays on its device; any other X goes to the CUDA
    device (``core/device.as_input``).
    """
    x = as_input(x)
    with torch.no_grad():
        x = (x + torch.clamp(-torch.min(x), min=0.0)).contiguous()
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"
    kernel = bool(use_pallas) and x.dtype == torch.float32 and objective_takes(x, k_row)
    objective = eu_residual_obj if kernel else eu_residual_obj_ref

    inits = (f_init is None, s_init is None, g_init is None)
    if len(set(inits)) != 1:
        raise ValueError("pass all of f_init/s_init/g_init, or none")
    with torch.no_grad(), full_f32():
        if f_init is not None:
            f, s, g = (torch.as_tensor(a, dtype=x.dtype, device=x.device)
                       for a in (f_init, s_init, g_init))
        else:
            # Ding et al. §5 init: k-means indicators on rows/columns
            # (+0.2 smoothing), S from the closed form F^T X G
            gen = make_generator(key, x.device)
            f = _kmeans_indicator(x, k_row, _seed_points(x.shape[0], k_row, gen))
            g = _kmeans_indicator(x.T.contiguous(), k_col,
                                  _seed_points(x.shape[1], k_col, gen))
            s = f.T @ x @ g / (torch.sum(f, dim=0)[:, None]
                               * torch.sum(g, dim=0)[None, :])
        f, s, g = f.contiguous(), s.contiguous(), g.contiguous()
        obj0 = objective(x, f, s @ g.T)

    experiment = MurExperiment(
        method="nmtf", components=k_row, distance_type="eu-triortho",
        nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=0.0, lambda_h=float(k_col),
    )

    carry = init_carry(obj0, max_iter, (f, s, g))

    def run(c, stop):
        return _nmtf_block(x, c, stop, tol1, tol2, objective=objective, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + f"|nmtf:{k_row}x{k_col}",
    )
    f, s, g = carry.inner
    i, obj_history = finalize_history(carry)
    res = Results(w=host_array(f), h=host_array(g.T), i=i,
                  obj_history=obj_history, experiment=experiment)
    return res, host_array(s)
