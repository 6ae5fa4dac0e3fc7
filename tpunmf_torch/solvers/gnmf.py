"""Graph-regularized NMF (GNMF) — manifold smoothness on the encodings, on PyTorch.

Same contract as ``tpunmf.solvers.gnmf`` (Cai, He, Han & Huang, TPAMI
2011): minimizes

    0.5 ||X - W H||_F^2 + 0.5 * lambda_g * Tr(H L H^T),   L = D - A,

for a symmetric non-negative affinity A over the n columns of X (e.g.
``knn_graph``) and its degree diagonal D, by the multiplicative updates

    W <- W * (X H^T) / (W (H H^T))
    H <- H * (W^T X + lambda_g * H A) / ((W^T W) H + lambda_g * H D)

with ``H A`` one (k, n) @ (n, n) product (A dense, a scipy sparse A
densified) and ``H D`` a row scale.  X is shifted by ``max(-min X, 0)``;
``lambda_g = 0`` is plain EU MUR.

The products are ``torch.matmul`` with TF32 off (``core/precision``).
``use_pallas`` (default: True exactly when X is a CUDA tensor) picks only
the data term ``0.5 ||X - W H||^2`` of the objective:
``eu_residual_obj`` (ops/fused.py) where ``objective_takes`` takes X and k
and X is float32, else its plain version.  It does not feed back, so both
routes give the same factors.  The random init draws from a
``torch.Generator`` (``key``: a generator or an int seed, default 0;
torch's draws differ from ``jax.random``'s).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.precision import full_f32
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from ..ops.fused import eu_residual_obj, eu_residual_obj_ref, objective_takes
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-9


@full_f32()
def knn_graph(x, n_neighbors: int = 5, *, mode: str = "heat",
              sigma: float | None = None):
    """Symmetric kNN affinity over the COLUMNS of x (dense (n, n)), on x's
    device.

    mode 'heat': exp(-||xi - xj||^2 / sigma) (sigma defaults to the mean
    squared neighbor distance); 'binary': 0/1 adjacency.  Each column keeps
    the columns within its ``n_neighbors``-th smallest distance (ties
    kept), the graph is symmetrized with max(A, A^T), and the diagonal is
    zeroed.
    """
    x = as_input(x)
    n = x.shape[1]
    if not 0 < n_neighbors < n:
        raise ValueError("need 0 < n_neighbors < n")
    with torch.no_grad():
        sq = torch.sum(x * x, dim=0)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (x.T @ x)
        d2 = torch.clamp(d2, min=0.0)
        d2.fill_diagonal_(float("inf"))                   # exclude self
        # keep the n_neighbors smallest distances per row
        thresh = torch.topk(d2, n_neighbors, dim=1, largest=False).values[:, -1]
        keep = d2 <= thresh[:, None]
        if mode == "binary":
            a = keep.to(x.dtype)
        elif mode == "heat":
            if sigma is None:
                sigma = torch.nanmean(torch.where(keep, d2, float("nan")))
            a = torch.where(keep, torch.exp(-d2 / sigma), 0.0).to(x.dtype)
        else:
            raise ValueError("mode must be 'heat' or 'binary'")
        a = torch.maximum(a, a.T)                           # symmetrize
        return a * (1.0 - torch.eye(n, dtype=x.dtype, device=x.device))


def _smoothness(h, a, deg):
    """Tr(H L H^T) = sum_j deg_j ||h_j||^2 - sum_ij A_ij <h_i, h_j>."""
    return torch.sum(deg * torch.sum(h * h, dim=0)) - torch.sum((h @ a) * h)


def _gnmf_block(x, a, deg, carry, stop_i, tol1, tol2, lam, *, data_term, min_iter: int,
                max_iter: int, verbose=False):
    def step(inner, i):
        w, h = inner
        w = w * (x @ h.T) / (w @ (h @ h.T) + _EPS)
        numer = w.T @ x + lam * (h @ a)
        denom = (w.T @ w) @ h + lam * (h * deg[None, :]) + _EPS
        h = h * numer / denom
        return (w, h), data_term(x, w, h) + 0.5 * lam * _smoothness(h, a, deg)

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def gnmf(
    x,
    k: int,
    adjacency,
    *,
    lambda_g: float = 1.0,
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    nndsvd_init=(False, "zero"),
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
    """Graph-regularized NMF (Cai et al. 2011 multiplicative updates).

    Args:
      adjacency: (n, n) symmetric non-negative affinity over the columns
        of x (a tensor, a numpy array or a scipy sparse matrix, densified
        on x's device; build one with :func:`knn_graph`).
      lambda_g: graph regularization weight (0 reduces to EU MUR).
      use_pallas: the objective kernel on/off (default: on for CUDA X).

    ``obj_history`` records the full regularized objective.  X that is a
    tensor stays on its device; any other X goes to the CUDA device
    (``core/device.as_input``).
    """
    x = as_input(x)
    with torch.no_grad():
        x = (x + torch.clamp(-torch.min(x), min=0.0)).contiguous()
    n = x.shape[1]
    if hasattr(adjacency, "toarray"):
        adjacency = adjacency.toarray()
    a = as_input(adjacency, dtype=x.dtype, device=x.device).contiguous()
    if tuple(a.shape) != (n, n):
        raise ValueError(f"adjacency must be ({n}, {n}); got {tuple(a.shape)}")
    if lambda_g < 0:
        raise ValueError("lambda_g must be >= 0")
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"
    kernel = bool(use_pallas) and x.dtype == torch.float32 and objective_takes(x, k)
    data_term = eu_residual_obj if kernel else eu_residual_obj_ref

    experiment = MurExperiment(
        method="gnmf", components=k, distance_type="eu-graph",
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=0.0, lambda_h=lambda_g,
    )

    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    lam = float(lambda_g)
    with torch.no_grad(), full_f32():
        deg = torch.sum(a, dim=1)
        if w_init is not None:
            w = torch.as_tensor(w_init, dtype=x.dtype, device=x.device)
            h = torch.as_tensor(h_init, dtype=x.dtype, device=x.device)
        elif nndsvd_init[0]:
            w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
            w = torch.clamp(w, min=1e-6)
            h = torch.clamp(h, min=1e-6)
        else:
            w, h = random_init(key, x.shape[0], n, k, kind="abs_normal",
                               dtype=x.dtype, device=x.device)
        # the kernel takes row-major factors (an SVD's U is column-major)
        w, h = w.contiguous(), h.contiguous()
        obj0 = data_term(x, w, h) + 0.5 * lam * _smoothness(h, a, deg)

    carry = init_carry(obj0, max_iter, (w, h))

    def run(c, stop):
        return _gnmf_block(x, a, deg, c, stop, tol1, tol2, lam, data_term=data_term,
                           min_iter=min_iter, max_iter=max_iter, verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment) + f"|gnmf:lam={lambda_g:g}",
    )
    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i,
                   obj_history=obj_history, experiment=experiment)
