"""Shared solver-driver machinery: a host loop with ``tpunmf``'s semantics.

``tpunmf`` runs each solver's loop as a ``lax.while_loop`` on the device.
Here the loop runs on the host: each iteration launches its kernels and
then reads the new objective to the host once, so that the loop stops at
exactly the same iteration as ``tpunmf``.  ``obj_buf`` is a preallocated
``(max_iter+1,)`` CPU tensor in the objective's dtype, NaN where nothing
was recorded.

Blocked execution (``block_size`` / ``on_block_end``) hands control back
between blocks with identical per-iteration semantics; ``run_loop`` adds
checkpoint/resume between blocks (``io/checkpoint.py``), through a
``store``: the one-device ``.npz`` files by default, or a mesh driver's
(``parallel/mesh_checkpoint.py``), which gathers the rank's blocks into
the same global files.
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
    store=None,
) -> LoopCarry:
    """drive() plus optional checkpoint/resume (tpunmf/solvers/common.py:236-271).

    With ``checkpoint_path`` set, the carry is saved atomically every block
    (block size defaults to ``checkpoint_every`` or 500) and, when
    ``resume=True`` and a checkpoint exists, restored before running: the
    loop continues from the saved iteration with identical semantics.
    ``config_tag`` is stored with each checkpoint and checked on resume, so
    a checkpoint of another configuration is refused even where the shapes
    coincide.  Each save copies the state to the host, which waits for the
    device.  ``store`` (``exists(path)``, ``load(path, carry, meta)``,
    ``save(path, carry, meta)``) is where the checkpoints go: by default
    the ``.npz`` files of ``io/checkpoint.py``.
    """
    if checkpoint_path:
        if store is None:
            store = NPZ_STORE
        if resume and store.exists(checkpoint_path):
            carry = store.load(checkpoint_path, carry, config_tag)
        if block_size is None:
            block_size = checkpoint_every or 500

        user_cb = on_block_end

        def on_block_end(c):
            store.save(checkpoint_path, c, config_tag)
            if user_cb is not None:
                user_cb(c)

    return drive(run_block, carry, max_iter=max_iter, block_size=block_size,
                 on_block_end=on_block_end)


class NpzStore:
    """One device's checkpoints: ``io/checkpoint.py``'s ``.npz`` files."""

    @staticmethod
    def exists(path):
        from ..io.checkpoint import checkpoint_exists

        return checkpoint_exists(path)

    @staticmethod
    def load(path, carry, meta):
        from ..io.checkpoint import load_state

        return load_state(path, carry, expected_meta=meta)

    @staticmethod
    def save(path, carry, meta):
        from ..io.checkpoint import save_state

        save_state(path, carry, meta=meta)


NPZ_STORE = NpzStore()


def finalize_history(carry: LoopCarry) -> tuple[int, list]:
    """Convert carry to the reference's (i, obj_history) convention."""
    completed = int(carry.i)
    obj_history = list(host_array(carry.obj_buf)[: completed + 1])
    return completed - 1, obj_history
