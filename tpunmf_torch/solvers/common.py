"""Shared solver-driver machinery: a host loop with ``tpunmf``'s semantics.

``tpunmf`` runs each solver's loop as a ``lax.while_loop`` on the device.
Here the loop runs on the host: each iteration launches its kernels and
then reads the new objective to the host once, so that the loop stops at
exactly the same iteration as ``tpunmf``.  ``obj_buf`` is a preallocated
``(max_iter+1,)`` CPU tensor in the objective's dtype, NaN where nothing
was recorded.

Blocked execution (``block_size`` / ``on_block_end``) hands control back
between blocks with identical per-iteration semantics.  Checkpointing is
not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.convergence import convergence_check


class LoopCarry(NamedTuple):
    """Generic solver loop state (same fields as ``tpunmf``'s).

    i: number of completed iterations (the returned ``i`` is ``carry.i - 1``).
    obj: last real objective, a 0-d CPU tensor (obj_buf[i] unless NaN).
    converged: sticky convergence flag.
    obj_buf: (max_iter+1,) CPU objective trace; obj_buf[0] is the init value.
    inner: solver-specific state (factors, cached ratios...).
    """

    i: int
    obj: torch.Tensor
    converged: bool
    obj_buf: torch.Tensor
    inner: Any


def host_array(a) -> np.ndarray:
    """A tensor (on any device) as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def verbose_precision(verbose, tol1, tol2):
    """The reference's per-iteration print precision (nmf/mur.py:93-95):
    the exponent of min(tol1, tol2) for tols < 1, else 2; tol <= 0 caps
    at 12 places.  False when not verbose."""
    if not verbose:
        return False
    tol = min(float(tol1), float(tol2))
    if tol >= 1:
        return 2
    if tol <= 0:
        return 12
    return max(int(format(tol, "e").split("-")[1]), 1)


def init_carry(obj0, max_iter: int, inner) -> LoopCarry:
    obj0 = torch.as_tensor(obj0).detach().cpu()
    obj_buf = torch.full((max_iter + 1,), math.nan, dtype=obj0.dtype)
    obj_buf[0] = obj0
    return LoopCarry(i=0, obj=obj0, converged=False, obj_buf=obj_buf,
                     inner=inner)


def while_block(
    step_fn: Callable[[Any, int], tuple[Any, torch.Tensor]],
    carry: LoopCarry,
    stop_i: int,
    tol1,
    tol2,
    *,
    min_iter: int,
    max_iter: int,
    verbose=False,
) -> LoopCarry:
    """Run the solver loop until stop_i / max_iter / convergence.

    ``step_fn(inner, i) -> (inner, obj)`` performs one full iteration.
    Convergence is checked only when ``i > min_iter`` (strict,
    nmf/mur.py:131), comparing the new objective with the last real one
    per nmf/utils.py:4-15, in the objective's dtype; the flag stops the
    loop *after* the iteration that triggered it.  A NaN objective
    (skipped by ``objective_every``, or diverged) is recorded as is, but
    neither enters the comparison nor displaces the held last real
    objective (tpunmf/solvers/common.py:181-211).
    """
    i, obj, conv, obj_buf, inner = carry
    obj_buf = obj_buf.clone()
    stop = min(int(stop_i), max_iter)
    while i < stop and not conv:
        inner, new = step_fn(inner, i)
        new = new.detach().to(device="cpu", dtype=obj.dtype)
        obj_buf[i + 1] = new
        real = not bool(torch.isnan(new))
        conv = real and i > min_iter and convergence_check(new, obj, tol1, tol2)
        if verbose:
            # the RAW objective: a skipped iteration prints nan
            if verbose is True:
                print(f"[{i}]: {float(new)}")
            else:
                print(f"[{i}]: {float(new):.{int(verbose)}f}")
        if real:
            obj = new
        i += 1
    return LoopCarry(i, obj, conv, obj_buf, inner)


def drive(
    run_block: Callable[..., LoopCarry],
    carry: LoopCarry,
    *,
    max_iter: int,
    block_size: Optional[int] = None,
    on_block_end: Optional[Callable[[LoopCarry], None]] = None,
) -> LoopCarry:
    """Blocked driver around ``run_block(carry, stop_i)``."""
    block = max_iter if block_size is None else max(1, int(block_size))
    while True:
        stop = min(carry.i + block, max_iter)
        carry = run_block(carry, stop)
        if on_block_end is not None:
            on_block_end(carry)
        if carry.i >= max_iter or carry.converged:
            return carry


def run_loop(
    run_block: Callable[..., LoopCarry],
    carry: LoopCarry,
    *,
    max_iter: int,
    block_size: Optional[int] = None,
    on_block_end: Optional[Callable[[LoopCarry], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    config_tag: Optional[str] = None,
) -> LoopCarry:
    """drive(); checkpoint/resume is not ported yet."""
    if checkpoint_path:
        raise NotImplementedError(
            "checkpoint_path: io/checkpoint.py is not ported yet "
            "(ROADMAP.md, queue 1, item 10 'Tooling')")
    return drive(run_block, carry, max_iter=max_iter, block_size=block_size,
                 on_block_end=on_block_end)


def finalize_history(carry: LoopCarry) -> tuple[int, list]:
    """Convert carry to the reference's (i, obj_history) convention."""
    completed = int(carry.i)
    obj_history = list(host_array(carry.obj_buf)[: completed + 1])
    return completed - 1, obj_history
