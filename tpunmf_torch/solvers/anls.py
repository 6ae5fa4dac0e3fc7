"""ANLS — alternating non-negative least squares (Kim & Park).

Same contract as ``tpunmf.solvers.anls`` (reference: nmf/anls.py:50-135):
each half-problem is the Tikhonov-augmented NNLS
``min ||[H^T; sqrt(2*lambda_w) I] W^T - [X^T; 0]||`` folded into the
normal equations, ``CtC = H H^T + 2*lambda*I`` and ``CtA = H X^T``, and
solved by the batched masked NNLS of ``tpunmf_torch/nnls``, warm-started
from the previous iterate's support and values; defaults, NNDSVD 'zero'
by default with U[0,1) for the random init, convergence semantics, and the
quirk that ``distance_type='kl'`` only changes the *reported* objective.
``use_fcnnls`` only tags the experiment (and so the save name): both of the
reference's NNLS paths have one fixed point.

The NNLS and the products ``H X^T``, ``W^T X`` and the Grams are the same
torch calls on both routes, with TF32 off (``core/precision.full_f32``).
``use_pallas`` (default: True exactly when X is a CUDA tensor) picks only
the objective: ``eu_residual_obj`` or ``kl_obj`` (ops/fused.py) where
``objective_takes`` takes X and k and X is float32, else their plain
versions.  ``kl_obj`` is the objective of ``tpunmf``'s
``kl_ratio_and_obj`` bit for bit without writing the m x n ratio that
``tpunmf`` discards.  The objective does not feed back, so both routes
give the same factors.

``device_loop`` is accepted; both of its values run the host loop of
``solvers/common.while_block``.  bfloat16 X raises, as ``tpunmf``'s
batched Cholesky does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.losses import distance
from ..core.precision import full_f32
from ..core.sums import LOCAL
from ..core.types import AnlsExperiment, Results
from ..init import nndsvd, random_init
from ..nnls import nnls_activeset, nnls_bpp
from ..ops.fused import eu_residual_obj, eu_residual_obj_ref, kl_obj, kl_obj_ref, objective_takes
from . import cuda_defaults
from .common import (LoopCarry, finalize_history, host_array, init_carry, run_loop,
                     verbose_precision, while_block)


def _make_solve(nnls_solver: str, solve_method: str, nnls_opts: dict):
    """Uniform half-problem solve: (ct_c, ct_a, prev) -> solution.

    ``prev`` is the previous iterate for this half: its support is the
    warm-start passive set (both solvers) and, for the active-set solver,
    its values the CG starting point."""
    if nnls_solver == "bpp":
        return lambda ct_c, ct_a, prev: nnls_bpp(ct_c, ct_a, prev > 0,
                                                 solve_method=solve_method)
    return lambda ct_c, ct_a, prev: nnls_activeset(
        ct_c, ct_a, prev > 0, prev, solve_method=solve_method, **nnls_opts)


def _anls_block(
    x,
    carry: LoopCarry,
    stop_i,
    tol1,
    tol2,
    lambda_w,
    lambda_h,
    *,
    k: int,
    distance_type: str,
    nnls_solver: str,
    solve_method: str,
    nnls_opts: dict,
    min_iter: int,
    max_iter: int,
    use_pallas: bool,
    verbose=False,
    sums=LOCAL,
) -> LoopCarry:
    """Run ANLS iterations from ``carry`` up to ``stop_i`` (or convergence).

    ``carry.inner`` is (w, h); ``use_pallas`` here means the objective
    kernels, which :func:`anls` chooses by X's dtype and rank.  Over a mesh
    (``parallel.anls_mesh``) ``x`` and the factors are this rank's blocks,
    ``sums`` (core/sums.py) all-reduces the normal equations' products and
    the objective, and the NNLS solves the rank's own columns, with no
    collective inside it."""
    solve = _make_solve(nnls_solver, solve_method, nnls_opts)
    eye = torch.eye(k, dtype=x.dtype, device=x.device)

    def objective(w, h):
        w, h = w.contiguous(), h.contiguous()  # w is a transposed view
        if distance_type == "kl":
            part = (kl_obj if use_pallas else kl_obj_ref)(x, w, h)
        else:
            part = (eu_residual_obj if use_pallas else eu_residual_obj_ref)(x, w, h)
        return sums.psum(part, "rows", "cols")

    def step(inner, i):
        w, h = inner
        # W update: normal equations of [h.T; sqrt(2*lw) I] vs [x.T; 0]
        # (nmf/anls.py:18-31 folded), warm-started from the previous W
        w = solve(sums.psum(h @ h.T, "cols") + 2.0 * lambda_w * eye,
                  sums.psum(h @ x.T, "cols"), w.T).T
        # H update (nmf/anls.py:34-47)
        h = solve(sums.psum(w.T @ w, "rows") + 2.0 * lambda_h * eye,
                  sums.psum(w.T @ x, "rows"), h)
        return (w, h), objective(w, h)

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def anls(
    x,
    k: int,
    *,
    distance_type: str = "eu",
    use_fcnnls: bool = False,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    min_iter: int = 10,
    max_iter: int = 1000,
    tol1: float = 1e-3,
    tol2: float = 1e-3,
    nndsvd_init=(True, "zero"),
    save_dir: str = "./results/",
    # --- extensions beyond the reference surface ---
    nnls_solver: str = "activeset",
    masked_solver: Optional[str] = None,
    nnls_opts: Optional[dict] = None,
    w_init=None,
    h_init=None,
    key=None,
    use_pallas: Optional[bool] = None,
    device_loop: Optional[bool] = None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """NMF via alternating non-negative least squares.

    Reference-compatible keyword surface (nmf/anls.py:50-52) plus, as in
    ``tpunmf``: ``nnls_solver`` ('activeset' | 'bpp'), ``masked_solver``
    ('chol' | 'cg'; default ``cuda_defaults.anls_masked_solver``, 'chol'),
    ``nnls_opts`` (active-set only: ``max_outer``, ``inner_cap``,
    ``opt_tol_ulps``, ``freeze_stalled``, ``cg_iters``, ``precision``),
    explicit ``w_init``/``h_init``, ``key`` (``torch.Generator`` or int
    seed; torch's draws differ from jax.random's), ``use_pallas``,
    ``device_loop`` (accepted; one host loop either way) and blocked
    execution.  X that is a tensor stays on its device; any other X goes to
    the CUDA device (``core/device.as_input``).
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if nnls_solver not in ("activeset", "bpp"):
        raise ValueError("nnls_solver must be 'activeset' or 'bpp'")
    if masked_solver not in (None, "chol", "cg"):
        raise ValueError("masked_solver must be 'chol' or 'cg'")
    nnls_opts = dict(nnls_opts or {})
    if nnls_opts and nnls_solver == "bpp":
        raise ValueError(
            "nnls_opts applies to the active-set solver only; it would be "
            "silently ignored with nnls_solver='bpp'")
    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")

    x = as_input(x).contiguous()
    if x.dtype == torch.bfloat16:
        raise NotImplementedError(
            "Unsupported dtype bfloat16: ANLS's batched Cholesky takes float32 or "
            "float64 X, as in tpunmf")
    if masked_solver is None:
        masked_solver = cuda_defaults.anls_masked_solver(x.device)
    if nnls_solver == "activeset" and masked_solver == "cg":
        nnls_opts.setdefault("cg_iters", cuda_defaults.anls_cg_iters(x.device))
        # TF32 off: the port's counterpart of tpunmf's 'highest'
        nnls_opts.setdefault("precision", None)
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"
    kernels = bool(use_pallas) and x.dtype == torch.float32 and objective_takes(x, k)

    experiment = AnlsExperiment(
        method="anls",
        components=k,
        distance_type=distance_type,
        nndsvd_init=nndsvd_init,
        max_iter=max_iter,
        tol1=tol1,
        tol2=tol2,
        lambda_w=lambda_w,
        lambda_h=lambda_h,
        fcnnls=use_fcnnls,
    )

    with torch.no_grad(), full_f32():
        if w_init is not None:
            w = torch.as_tensor(w_init, dtype=x.dtype, device=x.device)
            h = torch.as_tensor(h_init, dtype=x.dtype, device=x.device)
        elif nndsvd_init[0]:
            w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
        else:
            # reference uses U[0,1) for ANLS (nmf/anls.py:104-105)
            w, h = random_init(key, x.shape[0], x.shape[1], k, kind="uniform",
                               dtype=x.dtype, device=x.device)
        # row-major factors, as the mesh solvers place their blocks: cuBLAS
        # rounds by layout, and an SVD's U (NNDSVD) is column-major
        w, h = w.contiguous(), h.contiguous()
        obj0 = distance(x, w @ h, distance_type)
    carry = init_carry(obj0, max_iter, (w, h))

    def run(c, stop):
        return _anls_block(
            x, c, stop, tol1, tol2, lambda_w, lambda_h, k=k,
            distance_type=distance_type, nnls_solver=nnls_solver,
            solve_method=masked_solver, nnls_opts=nnls_opts, min_iter=min_iter,
            max_iter=max_iter, use_pallas=kernels,
            verbose=verbose_precision(verbose, tol1, tol2),
        )

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        # the NNLS configuration changes the trajectory but is not an
        # Experiment field, so a checkpoint tag carries it
        config_tag=repr(experiment)
        + f"|nnls={nnls_solver},{masked_solver},{tuple(sorted(nnls_opts.items()))}",
    )

    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)
