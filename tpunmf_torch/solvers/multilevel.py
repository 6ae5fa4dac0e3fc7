"""Multilevel NMF: coarsen -> solve -> prolongate -> refine, on PyTorch.

Same contract as ``tpunmf.solvers.multilevel`` (after Gillis & Glineur,
"A Multilevel Approach for Nonnegative Matrix Factorization",
arXiv:1009.0881): the restriction operator sums groups of ``factor``
adjacent columns (``X_c = X P`` with P the non-negative aggregation
matrix), and prolongation spreads each coarse H column uniformly over its
group, so the coarse W is directly a fine W.  The coarsest level is
solved from the inner solver's own default init, each finer level from
the prolongated factors; the finest ``Results`` is returned (its
``obj_history`` covers the fine solve only).

The inner solver is the port's ``mur`` or ``hals``, with its kernel
routes: every level's X is a row-major tensor on X's device, so the
kernels take it as they take any X.  ``axis=0`` coarsens rows by running
the mirror problem on a row-major copy of X^T (a transposed view would
change cuBLAS's roundings and break the kernels' alignment), with
``lambda_w`` and ``lambda_h`` swapped.
"""
from __future__ import annotations

import torch

from ..core.device import as_input
from ..core.types import Results


def _get_solver(method: str):
    from .hals import hals
    from .mur import mur

    table = {"mur": mur, "hals": hals}
    if method not in table:
        raise KeyError(f"multilevel supports {sorted(table)}; got {method!r}")
    return table[method]


def coarsen_columns(x, factor: int):
    """Aggregate groups of ``factor`` adjacent columns by summation.

    Ragged tails are zero-padded (zero columns prolongate to near-zero
    H entries — harmless for an init)."""
    m, n = x.shape
    pad = (-n) % factor
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(m, (n + pad) // factor, factor).sum(dim=2)


def prolongate_h(h_c, factor: int, n: int):
    """Spread each coarse H column uniformly over its fine group."""
    h = torch.repeat_interleave(torch.as_tensor(h_c) / factor, factor, dim=1)
    return h[:, :n]


def multilevel(
    x,
    k: int,
    *,
    method: str = "hals",
    levels: int = 2,
    factor: int = 4,
    coarse_iters: int = 200,
    axis: int = 1,
    key=None,
    **params,
) -> Results:
    """NMF with a multilevel warm start (arXiv:1009.0881 scheme).

    Args:
      method: inner solver ('mur' or 'hals'); ``params`` go to it
        verbatim at the finest level (distance_type, tolerances, ...).
      levels: coarsening depth; level L solves an
        ``n / factor**L``-column problem.
      factor: column-aggregation width per level.
      coarse_iters: max iterations at each coarse level (tolerances are
        inherited from ``params``; coarse levels converge fast).
      axis: 1 coarsens columns (default), 0 coarsens rows (via
        transposition — factors are transposed back).

    Returns the finest-level ``Results`` (its obj_history covers the
    fine solve only; coarse work is the warm start).  X that is a tensor
    stays on its device; any other X goes to the CUDA device.
    """
    check_levels(levels, factor)
    if axis == 0:
        res = multilevel(as_input(x).T.contiguous(), k, method=method, levels=levels,
                         factor=factor, coarse_iters=coarse_iters, axis=1, key=key,
                         **swapped(params))
        return transposed(res)
    x = as_input(x)
    return solve_up(_get_solver(method), build_pyramid(x, k, levels, factor), k, factor,
                    coarse_iters, key, params)


def check_levels(levels: int, factor: int) -> None:
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if factor < 2:
        raise ValueError("factor must be >= 2")


def swapped(params) -> dict:
    """``params`` for the transposed problem, which swaps the factor roles
    and so the per-factor regularizers (remove-then-reinsert: a lone
    lambda_w must become lambda_h, not apply to both)."""
    sw = dict(params)
    lw = sw.pop("lambda_w", None)
    lh = sw.pop("lambda_h", None)
    if lh is not None:
        sw["lambda_w"] = lh
    if lw is not None:
        sw["lambda_h"] = lw
    return sw


def transposed(res) -> Results:
    """The transposed problem's ``Results`` with its factors transposed back."""
    return Results(w=res.h.T, h=res.w.T, i=res.i, obj_history=res.obj_history,
                   experiment=res.experiment)


def build_pyramid(x, k: int, levels: int, factor: int) -> list:
    """[X, X coarsened once, ...] (fine -> coarse), stopping early where a
    level would drop below ~4k columns of rank headroom."""
    pyramid = [x]
    for _ in range(levels):
        nxt = coarsen_columns(pyramid[-1], factor)
        if nxt.shape[1] < max(2 * k, 8):
            break
        pyramid.append(nxt)
    return pyramid


def solve_up(solver, pyramid, k: int, factor: int, coarse_iters: int, key, params):
    """The coarsest level from ``solver``'s own default init, then each
    finer level from the prolongated factors; the finest ``Results``.
    ``solver(x, k, **kw)`` is ``mur`` or ``hals``, or their mesh drivers."""
    coarse_params = {kk: v for kk, v in params.items()
                     if kk not in ("min_iter", "max_iter", "w_init", "h_init", "verbose")}
    res_c = solver(pyramid[-1], k, max_iter=coarse_iters, key=key, **coarse_params)
    w, h_c = res_c.w, res_c.h
    # prolongate + refine up the pyramid
    for lvl in range(len(pyramid) - 2, 0, -1):
        h0 = prolongate_h(h_c, factor, pyramid[lvl].shape[1])
        res_mid = solver(pyramid[lvl], k, w_init=w, h_init=h0, max_iter=coarse_iters,
                         **coarse_params)
        w, h_c = res_mid.w, res_mid.h
    h0 = prolongate_h(h_c, factor, pyramid[0].shape[1])
    return solver(pyramid[0], k, w_init=w, h_init=h0, **params)


def mur_multilevel(x, k, **kw) -> Results:
    """Convenience: multilevel(…, method='mur')."""
    return multilevel(x, k, method="mur", **kw)
