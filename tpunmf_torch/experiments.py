"""Experiments: grid search, the batched lambda grid, rank selection.

Same surface as ``tpunmf.experiments`` (the reference's legacy CLI loop,
nmf/nmf_old.py:52-54, and its parameter modules, :14-18), on the port:

- ``grid_search`` runs the facade once per (k, lambda_w, lambda_h);
- ``mur_lambda_grid`` runs MUR for every (lambda_w, lambda_h) together,
  from one shared init, for exactly ``n_iter`` iterations;
- ``rank_scan`` scores candidate ranks by the stability of the seeds'
  clusterings;
- ``corcondia`` is the CP core-consistency diagnostic, and
  ``ntf_rank_scan`` fits a CP model at each candidate rank and scores it
  by its fit and its core consistency.

Where ``tpunmf`` vmaps a run over the grid or the seeds, the port folds
the batch into the products' N dimension, so X is read once per product:
``X @ Hcat^T`` with ``Hcat`` of shape (B*k, n), and ``Wcat^T @ X``; the
k x k Grams are one ``bmm``.  A combination's objective, and KL's ratio,
go through the objective kernels (``ops/fused.py``) one combination at a
time, so that one m x n temporary exists at a time; every product runs
with TF32 off.
"""
from __future__ import annotations

import string
from itertools import product
from typing import Sequence

import numpy as np
import torch

from .api import NMF
from .core.device import as_input
from .core.precision import full_f32
from .init import random_init
from .ops import fused
# the update rules with their numerators given: one copy, on batches too
from .solvers.streaming import (_mur_h_update_eu, _mur_h_update_kl, _mur_w_update_eu,
                                _mur_w_update_kl)

_EPS = 1e-9


def grid_search(
    data,
    *,
    method: str = "mur",
    features: Sequence[int] = (10,),
    lambda_w: Sequence[float] = (0.0,),
    lambda_h: Sequence[float] = (0.0,),
    save_dir: str | None = None,
    **fixed_params,
) -> list:
    """Run a factorization for every (k, lambda_w, lambda_h) combination.

    Mirrors the legacy CLI's loop (nmf/nmf_old.py:52-54) with the modern
    API; extra solver kwargs are passed through unchanged.  Returns a list
    of (params_dict, Results).
    """
    out = []
    for k, lw, lh in product(features, lambda_w, lambda_h):
        model = NMF(data, k)
        params = dict(lambda_w=lw, lambda_h=lh, **fixed_params)
        if method in ("admm", "ao_admm"):
            # map scalar lambdas onto the (value, type) reg tuples; the
            # fallback types are the solvers' own defaults
            # (admm/ao_admm: reg_w=(0,'nn'), reg_h=(0,'l2n'))
            reg_w = fixed_params.get("reg_w", (lw, "nn"))
            reg_h = fixed_params.get("reg_h", (lh, "l2n"))
            params = {k_: v for k_, v in fixed_params.items()
                      if k_ not in ("reg_w", "reg_h")}
            params.update(reg_w=(lw, reg_w[1]), reg_h=(lh, reg_h[1]))
        results = model.factorize(method=method, **params)
        if save_dir is not None:
            model.save_factorization(save_dir=save_dir)
        out.append((dict(k=k, lambda_w=lw, lambda_h=lh), results))
    return out


def _objective_passes(x, k):
    """(EU objective, KL objective, KL ratio): the kernels' wrappers where
    they take X at rank k (on the CPU, their plain versions), else the
    plain versions."""
    if fused.objective_takes(x, k):
        return fused.eu_residual_obj, fused.kl_obj, fused.kl_ratio
    return fused.eu_residual_obj_ref, fused.kl_obj_ref, fused.kl_ratio_ref


def _batched_mur(x, ws, hs, lws, lhs, distance_type, n_iter, trace):
    """``n_iter`` MUR iterations of B independent runs on one X.

    ws (B, m, k), hs (B, k, n); lws, lhs (B, 1, 1).  EU folds the runs into
    the products' N dimension (one read of X per product); KL forms each
    run's ratio in turn.  Returns (ws, hs, objs): objs is (B, n_iter) with
    ``trace``, else the final iterate's (B,)."""
    n_runs, m, k = ws.shape
    n = hs.shape[2]
    eu_obj, kl_obj, kl_ratio = _objective_passes(x, k)
    xf = x.to(ws.dtype)  # the EU products promote X as tpunmf's do

    def objectives(ws, hs):
        fn = kl_obj if distance_type == "kl" else eu_obj
        return torch.stack([fn(x, ws[b], hs[b]).to(ws.dtype) for b in range(n_runs)])

    objs = []
    for _ in range(n_iter):
        if distance_type == "kl":
            numer = torch.stack([kl_ratio(x, ws[b], hs[b], eps=_EPS) @ hs[b].T
                                 for b in range(n_runs)])
            ws = _mur_w_update_kl(ws, numer, hs, lws)
            numer = torch.stack([ws[b].T @ kl_ratio(x, ws[b], hs[b], eps=_EPS)
                                 for b in range(n_runs)])
            hs = _mur_h_update_kl(hs, numer, ws, lhs)
        else:
            xht = xf @ hs.reshape(n_runs * k, n).T                    # (m, B*k)
            numer = xht.reshape(m, n_runs, k).transpose(0, 1)         # (B, m, k)
            ws = _mur_w_update_eu(ws, numer, torch.bmm(hs, hs.transpose(1, 2)), lws)
            wcat = ws.transpose(0, 1).reshape(m, n_runs * k)
            wtx = (wcat.T @ xf).reshape(n_runs, k, n)                 # (B, k, n)
            hs = _mur_h_update_eu(hs, wtx, torch.bmm(ws.transpose(1, 2), ws), lhs)
        if trace:
            objs.append(objectives(ws, hs))
    if trace:
        return ws, hs, torch.stack(objs, dim=1)
    return ws, hs, objectives(ws, hs)


def mur_lambda_grid(
    data,
    k: int,
    *,
    lambda_w: Sequence[float] = (0.0,),
    lambda_h: Sequence[float] = (0.0,),
    distance_type: str = "eu",
    n_iter: int = 200,
    w_init=None,
    h_init=None,
    key=None,
    mesh=None,
    grid_axis: str | None = None,
):
    """MUR over the full (lambda_w x lambda_h) grid, every combination
    together.

    Every combination starts from the same init and runs exactly
    ``n_iter`` iterations (no per-combination early stopping: pick winners
    from the returned objective trajectories).  ``key`` (a
    ``torch.Generator`` or int seed) draws the shared random init where
    ``w_init``/``h_init`` are not given.  X that is a tensor stays on its
    device; other X goes to the CUDA device.

    Returns ``(combos, ws, hs, obj_hist)`` where combos is the list of
    (lambda_w, lambda_h) pairs in row-major grid order, ws is (B, m, k), hs
    is (B, k, n) and obj_hist is (B, n_iter), tensors on X's device.

    ``mesh`` (``tpunmf_torch.parallel``) splits the combinations over
    ``grid_axis`` (default: the mesh's first axis), X replicated: each
    rank passes the global data, runs its share and gets all of them back
    (all_gather over the axis), on the mesh's device; the random init is
    drawn on rank 0 and broadcast.  The combinations must divide the
    axis's size.
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    combos = [(lw, lh) for lw in lambda_w for lh in lambda_h]
    if mesh is not None:
        from .parallel.mesh import axis_index, axis_size, mesh_device

        grid_axis = grid_axis or mesh.mesh_dim_names[0]
        size = axis_size(mesh, grid_axis)
        if len(combos) % size:
            raise ValueError(f"{len(combos)} grid combinations do not divide across mesh "
                             f"axis {grid_axis!r} of size {size}")
        x = as_input(data, device=mesh_device(mesh))
        share = len(combos) // size
        mine = combos[axis_index(mesh, grid_axis) * share:][:share]
    else:
        x = as_input(data)
        mine = combos
    m, n = x.shape
    factor_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    if w_init is None:
        w0, h0 = random_init(key, m, n, k, kind="abs_normal", dtype=factor_dtype,
                             device=x.device)
        if mesh is not None:
            from .parallel.collectives import broadcast

            broadcast(w0)
            broadcast(h0)
    else:
        w0 = as_input(w_init, dtype=factor_dtype, device=x.device)
        h0 = as_input(h_init, dtype=factor_dtype, device=x.device)

    n_runs = len(mine)
    lws = torch.tensor([c[0] for c in mine], dtype=factor_dtype,
                       device=x.device).reshape(n_runs, 1, 1)
    lhs = torch.tensor([c[1] for c in mine], dtype=factor_dtype,
                       device=x.device).reshape(n_runs, 1, 1)
    with torch.no_grad(), full_f32():
        ws, hs, objs = _batched_mur(
            x.contiguous(), w0.expand(n_runs, m, k).contiguous(),
            h0.expand(n_runs, k, n).contiguous(), lws, lhs, distance_type, n_iter,
            trace=True)
        if mesh is not None:
            from .parallel.collectives import all_gather

            ws, hs, objs = (all_gather(a, mesh, grid_axis, dim=0) for a in (ws, hs, objs))
    return combos, ws, hs, objs


def rank_scan_body(x, w0s, h0s, distance_type: str, n_iter: int):
    """One rank of :func:`rank_scan` from given inits.

    w0s (S, m, k) and h0s (S, k, n) are the seeds' inits.  Runs ``n_iter``
    unregularized MUR iterations of every seed, labels each column of X by
    its dominant component (``argmax`` of H's column, the first on a tie),
    and forms the consensus matrix as one product of the seeds' one-hot
    labels, ``C = Ecat^T Ecat / S`` with Ecat (S*k, n): its entries are
    small integers over S, exact, and one n x n array exists.  Returns
    (dispersion = mean(4 (C - 1/2)^2), mean final objective)."""
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    x = as_input(x)
    n_seeds, _, k = w0s.shape
    n = x.shape[1]
    with torch.no_grad(), full_f32():
        zeros = torch.zeros((n_seeds, 1, 1), dtype=w0s.dtype, device=x.device)
        _, hs, objs = _batched_mur(x.contiguous(), w0s, h0s, zeros, zeros,
                                   distance_type, n_iter, trace=False)
        labels = torch.argmax(hs, dim=1)                              # (S, n)
        onehot = torch.zeros((n_seeds, k, n), dtype=w0s.dtype, device=x.device)
        onehot.scatter_(1, labels.unsqueeze(1), 1.0)
        ecat = onehot.reshape(n_seeds * k, n)
        consensus = (ecat.T @ ecat) / n_seeds
        dispersion = torch.mean(4.0 * (consensus - 0.5) ** 2)
    return float(dispersion), float(torch.mean(objs))


def _rank_seed(key, index: int) -> int:
    """The seed of one fit's draws: a function of ``key`` and ``index``
    alone (``rank_scan`` passes the rank, ``ntf_rank_scan`` the position
    in ``ks``, as ``tpunmf`` folds each into its key with ``fold_in``), so
    a fit's draws do not depend on which others are scanned."""
    base = key.initial_seed() if isinstance(key, torch.Generator) else (
        0 if key is None else int(key))
    return int(np.random.SeedSequence([base, index]).generate_state(1, np.uint64)[0] >> 1)


def rank_scan(
    data,
    ks: Sequence[int],
    *,
    n_seeds: int = 8,
    distance_type: str = "eu",
    n_iter: int = 200,
    key=None,
):
    """Consensus-based rank selection (Brunet et al. / Kim-Park).

    For each candidate rank k, runs ``n_seeds`` random-init MUR
    factorizations together (:func:`rank_scan_body`), builds the sample
    consensus matrix C (how often two samples' dominant components
    coincide across seeds) and scores its stability with the dispersion
    coefficient ``rho = mean(4 (C - 1/2)^2)``: rho == 1 iff every seed
    clusters the samples identically.  The elbow/maximum of rho over k is
    the standard rank choice.  ``key``: an int seed or a
    ``torch.Generator`` (its initial seed); torch's draws differ from
    ``jax.random``'s.

    The consensus matrix is (n, n): subsample columns first for very wide
    data.

    Returns a list of dicts: {k, dispersion, mean_final_obj}.
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    x = as_input(data)
    m, n = x.shape
    dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    out = []
    for k in ks:
        k = int(k)
        g = torch.Generator(device=x.device)
        g.manual_seed(_rank_seed(key, k))
        draws = [random_init(g, m, n, k, kind="abs_normal", dtype=dtype)
                 for _ in range(n_seeds)]
        w0s = torch.stack([w for w, _ in draws])
        h0s = torch.stack([h for _, h in draws])
        del draws
        disp, obj = rank_scan_body(x, w0s, h0s, distance_type, n_iter)
        out.append({"k": k, "dispersion": disp, "mean_final_obj": obj})
    return out


def run_param_file(data, factors: int, param_module: str, method: str = "mur"):
    """Factorize using a parameter module exposing ``method_params``
    (the reference's param_file mechanism, nmf/nmf.py:38-45)."""
    model = NMF(data, factors, param_file=param_module)
    return model.factorize(method=method)


def corcondia(x, factors) -> float:
    """Core-consistency diagnostic for a CP model (Bro & Kiers 2003).

    Fits the unconstrained Tucker core G to the data given the CP factors
    (G = X contracted with each factor's pseudo-inverse) and scores how
    close G is to the superdiagonal identity the CP model implies:

        corcondia = 100 * (1 - ||G - I_sd||_F^2 / k)

    ~100 means the CP structure is appropriate at this rank; it collapses
    (often negative) once the rank over-fits.  The pseudo-inverses are k x k
    solves against each factor's Gram, and X is contracted once
    (``torch.einsum``, TF32 off).

    Args:
      x: the data tensor (a tensor stays on its device; other input goes
        to the CUDA device).
      factors: CP factor list, each (dim_d, k).
    Returns: the diagnostic in (-inf, 100].
    """
    x = as_input(x)
    fs = [torch.as_tensor(f, dtype=x.dtype, device=x.device) for f in factors]
    ndim = x.ndim
    k = fs[0].shape[1]
    with torch.no_grad(), full_f32():
        eye = torch.eye(k, dtype=x.dtype, device=x.device)
        # pinv(F_d) = solve(F_d^T F_d, F_d^T): k x dim_d
        pinvs = [torch.linalg.solve(f.T @ f + 1e-12 * eye, f.T) for f in fs]
        ax = string.ascii_lowercase[:ndim]
        core_ax = string.ascii_lowercase[ndim:2 * ndim]
        spec = (ax + "," + ",".join(c + a for c, a in zip(core_ax, ax))
                + "->" + core_ax)
        g = torch.einsum(spec, x, *pinvs)                 # (k, ..., k) core
        ideal = torch.zeros((k,) * ndim, dtype=g.dtype, device=g.device)
        idx = (torch.arange(k, device=g.device),) * ndim
        ideal[idx] = 1.0
        return float(100.0 * (1.0 - torch.sum((g - ideal) ** 2) / k))


def ntf_rank_scan(
    x,
    ks: Sequence[int],
    *,
    update: str = "hals",
    n_iter: int = 200,
    key=None,
) -> list:
    """CP rank selection: fit + core consistency per candidate rank.

    Fits a CP model at each rank (``solvers.ntf``, ``n_iter`` iterations at
    most, ``min_iter`` 10, tolerances 1e-9) and reports the relative
    reconstruction error together with :func:`corcondia`.  The usual
    reading: pick the largest k whose core consistency stays high (~>50)
    before the collapse.  Rank ``ks[i]``'s init is drawn from a generator
    seeded by ``key`` (an int seed or a ``torch.Generator``'s initial seed,
    default 0) and i, as ``tpunmf`` folds i into its key; torch's draws
    differ from ``jax.random``'s.

    Returns a list of dicts: {k, rel_err, corcondia, final_obj}.
    """
    from .solvers.ntf import cp_reconstruct, ntf

    x = as_input(x)
    with torch.no_grad(), full_f32():
        xnorm = float(torch.linalg.norm(x))
    out = []
    for i, k in enumerate(ks):
        g = torch.Generator(device=x.device)
        g.manual_seed(_rank_seed(key, i))
        res = ntf(x, int(k), update=update, max_iter=n_iter, min_iter=10,
                  tol1=1e-9, tol2=1e-9, key=g)
        with torch.no_grad(), full_f32():
            xhat = cp_reconstruct([torch.as_tensor(f, device=x.device) for f in res.factors])
            rel = float(torch.linalg.norm(x - xhat)) / (xnorm + 1e-30)
        del xhat
        out.append({
            "k": int(k),
            "rel_err": rel,
            "corcondia": corcondia(x, res.factors),
            "final_obj": float(res.obj_history[-1]),
        })
    return out
