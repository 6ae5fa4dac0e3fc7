"""HALS — accelerated hierarchical alternating least squares, on PyTorch.

Same contract as ``tpunmf.solvers.hals`` (Cichocki-Phan HALS with the
Gillis-Glineur acceleration, arXiv:1107.5194): per outer iteration the
cross-products ``X H^T`` / ``W^T X`` and the k x k Grams are formed once,
then the rank-1 column sweep runs ``inner_sweeps`` times against them;
the Tikhonov weights ``lambda_w``/``lambda_h``, the 1e-16 guard, the nudge
of generated inits, defaults, convergence semantics and the ``Results``
record are ``tpunmf``'s.  Euclidean objective only.

The kernels, chosen by ``use_pallas`` (the switch ``tpunmf`` passes to
its ``_hals_block``; it defaults to True exactly when X is a CUDA tensor)
and X's dtype and rank, the sweeps and the objective each on its own:

  * sweeps: ``gs_sweep`` (ops/hals_sweep.py) for both halves where the
    sweep kernel takes X and k (float32 X, as ``tpunmf`` engages its sweep
    kernel only for f32 X, tpunmf/solvers/hals.py:236-237, and k <= 1024:
    ``sweep_takes``); elsewhere the same sweeps as a loop of PyTorch ops
    (``gs_sweep_ref``).
  * exact objective: ``eu_residual_obj`` (ops/fused.py) for float32 X
    where the objective kernels take k (k <= 2048: ``objective_takes``);
    elsewhere its plain version.  So float32 X at 1024 < k <= 2048 sweeps
    in PyTorch and takes the objective kernel.
On CUDA the wrappers launch the hand-written kernels; on the CPU they run
their plain versions.  The factors keep X's dtype, as in ``tpunmf``, and
the kernels take float32 factors, so bfloat16 and float64 X run plain.

The GEMMs ``X H^T``, ``W^T X`` and the Grams are plain ``torch.matmul``
on both routes, with TF32 off (``tpunmf`` leaves them to XLA).

The single pass (``step_single``, tpunmf/solvers/hals.py:95-118): the W
half and the H numerator from one read of X by ``hals_iteration_eu``
(ops/hals_sweep.py), then the H sweeps and the objective.  Taken exactly
where ``tpunmf`` takes it (hals.py:236-241): the sweep kernel is engaged,
the port's switch ``cuda_defaults.hals_single_pass`` is on (off by
default, as in ``tpunmf``) and ``hals_iter_tileable`` gives a strip
height.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import as_input
from ..core.losses import eu_objective_gram
from ..core.precision import full_f32
from ..core.sums import LOCAL
from ..core.types import MurExperiment, Results
from ..init import nndsvd, random_init
from ..ops.fused import eu_residual_obj, eu_residual_obj_ref, objective_takes
from ..ops.hals_sweep import (gs_sweep, gs_sweep_ref, hals_iter_tileable,
                              hals_iteration_eu, sweep_takes)
from . import cuda_defaults
from .common import finalize_history, host_array, init_carry, run_loop, while_block

_EPS = 1e-16


def _hals_block(x, xsq, carry, stop_i, tol1, tol2, lambda_w, lambda_h, *,
                min_iter: int, max_iter: int, inner_sweeps: int,
                objective: str, sweep_kernel: bool, objective_kernel: bool,
                single_pass_bm=None, verbose=False, sums=LOCAL):
    """Run HALS iterations from ``carry`` up to ``stop_i`` (or convergence);
    ``sweep_kernel`` and ``objective_kernel`` select the kernels, and a
    ``single_pass_bm`` the single pass (see the module docstring).  Over a
    mesh (``parallel.hals_mesh``) ``x`` and the factors are this rank's
    blocks and ``sums`` (core/sums.py) all-reduces the products and the
    objective; the sweeps run on the rank's rows and columns."""
    sweep = gs_sweep if sweep_kernel else gs_sweep_ref
    residual = eu_residual_obj if objective_kernel else eu_residual_obj_ref

    def h_half_and_objective(w, h, wtx, wtw):
        h = sweep(wtx, wtw, h, lam=lambda_h, nsweeps=inner_sweeps)
        if objective == "gram":
            obj = eu_objective_gram(xsq, wtx, wtw, h, sums)
        else:
            obj = sums.psum(residual(x, w, h), "rows", "cols")
        return (w, h), obj

    def step_single(inner, i):
        """The W half and the H numerator in one pass over X."""
        w, h = inner
        w, wtx, wtw = hals_iteration_eu(x, w, h, lam_w=lambda_w, nsweeps=inner_sweeps,
                                        bm=single_pass_bm)
        return h_half_and_objective(w, h, wtx, wtw)

    def step(inner, i):
        w, h = inner
        # W half: one m*n*k GEMM + k x k Gram, then the sweeps in the
        # transposed frame (the result's .T is row-major again)
        xht = sums.psum(x @ h.T, "cols")
        hht = sums.psum(h @ h.T, "cols")
        w = sweep(xht.T, hht, w.T, lam=lambda_w, nsweeps=inner_sweeps).T
        # H half (mirror)
        return h_half_and_objective(w, h, sums.psum(w.T @ x, "rows"),
                                    sums.psum(w.T @ w, "rows"))

    chosen = step if single_pass_bm is None else step_single
    with torch.no_grad(), full_f32():
        return while_block(chosen, carry, stop_i, tol1, tol2, min_iter=min_iter,
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
    of ``tpunmf``'s XLA loop.  ``use_pallas``: kernels on/off (default on
    for CUDA X; they engage for float32 X, the sweeps up to k = 1024 and
    the objective up to 2048).  ``checkpoint_path`` / ``checkpoint_every``
    / ``resume``: periodic saves and restart (``solvers/common.run_loop``).
    """
    if distance_type != "eu":
        raise KeyError("HALS is Euclidean-only; use mur/admm for 'kl'.")
    if inner_sweeps < 1:
        raise ValueError("inner_sweeps must be >= 1")

    x = as_input(x)
    if use_pallas is None:
        use_pallas = x.device.type == "cuda"
    sweep_kernel = bool(use_pallas) and sweep_takes(x, k)
    # the factors keep X's dtype and the kernels take float32 factors
    objective_kernel = (bool(use_pallas) and x.dtype == torch.float32
                        and objective_takes(x, k))
    single_pass_bm = None
    if sweep_kernel and cuda_defaults.hals_single_pass(x.device):
        single_pass_bm = hals_iter_tileable(x, k)

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
        obj0 = (eu_residual_obj if objective_kernel else eu_residual_obj_ref)(x, w, h)

    carry = init_carry(obj0, max_iter, (w, h))

    def run(c, stop):
        return _hals_block(
            x, xsq, c, stop, tol1, tol2, float(lambda_w), float(lambda_h),
            min_iter=min_iter, max_iter=max_iter, inner_sweeps=inner_sweeps,
            objective=objective, sweep_kernel=sweep_kernel,
            objective_kernel=objective_kernel, single_pass_bm=single_pass_bm,
            verbose=verbose)

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
