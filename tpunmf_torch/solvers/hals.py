"""HALS — accelerated hierarchical alternating least squares, on PyTorch.

Same contract as ``tpunmf.solvers.hals`` (Cichocki-Phan HALS with the
Gillis-Glineur acceleration, arXiv:1107.5194): per outer iteration the
cross-products ``X H^T`` / ``W^T X`` and the k x k Grams are formed once,
then the rank-1 column sweep runs ``inner_sweeps`` times against them;
the Tikhonov weights ``lambda_w``/``lambda_h``, the 1e-16 guard, the nudge
of generated inits, defaults, convergence semantics and the ``Results``
record are ``tpunmf``'s.  Euclidean objective only.

Two routes, chosen by ``use_pallas`` (the switch ``tpunmf`` passes to its
``_hals_block``; it defaults to True exactly when X is a CUDA tensor):

  * kernel route, for float32 X only (as ``tpunmf`` engages its sweep
    kernel only for f32 X, tpunmf/solvers/hals.py:236-237): both halves
    sweep with ``gs_sweep`` (ops/hals_sweep.py) and the exact objective is
    ``eu_residual_obj`` (ops/fused.py).  On CUDA these launch the
    hand-written kernels; on the CPU they run their plain versions.
  * plain route (``use_pallas=False``, or X not float32): the same sweeps
    as a loop of PyTorch ops (``gs_sweep_ref``) and the plain objective.
    The factors keep X's dtype, as in ``tpunmf``.

The GEMMs ``X H^T``, ``W^T X`` and the Grams are plain ``torch.matmul``
on both routes, with TF32 off (``tpunmf`` leaves them to XLA).  The
single-pass HALS kernel (``hals_iteration_eu``) is off by default in
``tpunmf`` and is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.losses import eu_objective_gram
from ..core.precision import full_f32
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from ..ops.fused import eu_residual_obj, eu_residual_obj_ref
from ..ops.hals_sweep import gs_sweep, gs_sweep_ref
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-16


def _hals_block(x, xsq, carry, stop_i, tol1, tol2, lambda_w, lambda_h, *,
                min_iter: int, max_iter: int, inner_sweeps: int,
                objective: str, kernels: bool, verbose=False):
    """Run HALS iterations from ``carry`` up to ``stop_i`` (or convergence);
    ``kernels`` selects the kernel route (see the module docstring)."""
    sweep = gs_sweep if kernels else gs_sweep_ref
    residual = eu_residual_obj if kernels else eu_residual_obj_ref

    def step(inner, i):
        w, h = inner
        # W half: one m*n*k GEMM + k x k Gram, then the sweeps in the
        # transposed frame (the result's .T is row-major again)
        xht = x @ h.T
        hht = h @ h.T
        w = sweep(xht.T, hht, w.T, lam=lambda_w, nsweeps=inner_sweeps).T
        # H half (mirror)
        wtx = w.T @ x
        wtw = w.T @ w
        h = sweep(wtx, wtw, h, lam=lambda_h, nsweeps=inner_sweeps)
        if objective == "gram":
            obj = eu_objective_gram(xsq, wtx, wtw, h)
        else:
            obj = residual(x, w, h)
        return (w, h), obj

    with torch.no_grad(), full_f32():
        return while_block(step, carry, stop_i, tol1, tol2, min_iter=min_iter,
                           max_iter=max_iter, verbose=verbose)


def hals(
    x,
    k: int,
    *,
    distance_type: str = "eu",
    min_iter: int = 20,
    max_iter: int = 1000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    nndsvd_init=(True, "zero"),
    inner_sweeps: int = 2,
    sweep_unroll: int = 8,
    w_init=None,
    h_init=None,
    key=None,
    objective: str = "exact",
    use_pallas: Optional[bool] = None,
    verbose: bool = False,
    block_size: Optional[int] = None,
    on_block_end=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
) -> Results:
    """NMF via accelerated hierarchical ALS (Euclidean objective).

    Keyword surface of ``tpunmf.solvers.hals``: min/max_iter, tol1/tol2,
    lambda_w/lambda_h (Tikhonov weights), nndsvd_init (default NNDSVD
    'zero'), w_init/h_init (used as given; generated inits are nudged to
    at least 1e-16 so that no component starts frozen), key (a
    ``torch.Generator`` or int seed), ``inner_sweeps`` (sweeps per
    cross-product), objective 'exact' or 'gram', block_size/on_block_end.
    ``sweep_unroll`` is accepted and has no effect: it is the unroll count
    of ``tpunmf``'s XLA loop.  ``use_pallas``: kernel route on/off (default
    on for CUDA X; the kernels engage for float32 X only).
    ``checkpoint_path`` is not ported yet and raises.
    """
    if distance_type != "eu":
        raise KeyError("HALS is Euclidean-only; use mur/admm for 'kl'.")
    if inner_sweeps < 1:
        raise ValueError("inner_sweeps must be >= 1")

    x = torch.as_tensor(x)
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"
    kernels = bool(use_pallas) and x.dtype == torch.float32

    experiment = MurExperiment(
        method="hals", components=k, distance_type="eu",
        nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
        lambda_w=lambda_w, lambda_h=lambda_h,
    )

    with torch.no_grad(), full_f32():
        x = x + torch.clamp(-torch.min(x), min=0.0)
        x = x.contiguous()
        if (w_init is None) != (h_init is None):
            raise ValueError("pass both w_init and h_init, or neither")
        if w_init is not None:
            w = torch.as_tensor(w_init, dtype=x.dtype, device=x.device)
            h = torch.as_tensor(h_init, dtype=x.dtype, device=x.device)
        else:
            if nndsvd_init[0]:
                w, h = nndsvd(x, k, variant=nndsvd_init[1], key=key)
            else:
                w, h = random_init(key, x.shape[0], x.shape[1], k,
                                   kind="abs_normal", dtype=x.dtype,
                                   device=x.device)
            # HALS divides by Gram diagonals: an all-zero H row (NNDSVD
            # 'zero' fill) would freeze its component forever
            w = torch.clamp(w, min=_EPS)
            h = torch.clamp(h, min=_EPS)
        # the kernels take row-major factors (an SVD's U is column-major)
        w, h = w.contiguous(), h.contiguous()

        if objective == "gram":
            xf = x.to(torch.float32) if x.dtype == torch.bfloat16 else x
            xsq = torch.sum(xf * xf)
        else:
            xsq = torch.zeros((), dtype=x.dtype, device=x.device)
        obj0 = (eu_residual_obj if kernels else eu_residual_obj_ref)(x, w, h)

    carry = init_carry(obj0, max_iter, (w, h))

    def run(c, stop):
        return _hals_block(
            x, xsq, c, stop, tol1, tol2, float(lambda_w), float(lambda_h),
            min_iter=min_iter, max_iter=max_iter, inner_sweeps=inner_sweeps,
            objective=objective, kernels=kernels, verbose=verbose)

    carry = run_loop(
        run, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume,
        config_tag=repr(experiment)
        + f"|hals:sweeps={inner_sweeps},obj={objective}",
    )

    w, h = carry.inner
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i,
                   obj_history=obj_history, experiment=experiment)
