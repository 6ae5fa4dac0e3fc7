"""Profiling and debugging aids, as ``tpunmf.utils.profiling``.

- ``trace(dir)``: a ``torch.profiler`` capture (CPU and CUDA activities)
  around a solver run, written into ``dir`` as a Chrome trace; open it in
  Perfetto.  CUPTI records the port's kernels, which are launched through
  ``ctypes``, like any other.
- ``named_scope(name)``: a ``torch.profiler.record_function`` range, plus
  an NVTX range where CUDA is available, for annotating custom steps.
- ``determinism_check``: same-seed bitwise reproducibility of tensors or
  arrays, wherever they live: a reduction whose order changes from run to
  run shows up as a bit mismatch.
- ``debug_nans``: raise ``FloatingPointError`` at the first ATen op whose
  floating output holds a NaN (the counterpart of ``jax_debug_nans``).
- ``enable_compilation_cache(dir)``: build and load the CUDA kernels in
  ``dir``, so later processes reuse the built library.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..io.checkpoint import flatten, to_host


def enable_compilation_cache(cache_dir: str | None = None) -> None:
    """Build and load the kernel library in ``cache_dir`` (default
    ``tpunmf-torch-kernels`` in the temporary directory; created if
    missing); raises if it was already loaded from another directory."""
    from ..ops import _build

    if cache_dir is None:
        cache_dir = os.path.join(tempfile.gettempdir(), "tpunmf-torch-kernels")
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed computation into
    ``log_dir`` (``trace.json``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def named_scope(name: str):
    """A named range in profiler traces (and in NVTX where CUDA is
    available)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Inside the context, the first ATen op that returns a floating
    tensor holding a NaN raises ``FloatingPointError`` naming the op (each
    check reads the device).  A CUDA kernel of ``ops/`` is not an ATen
    op: its output is checked where the next op reads it."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


def determinism_check(fn: Callable[[], object], runs: int = 2) -> bool:
    """Run ``fn`` repeatedly and verify bitwise-identical outputs (tensors
    on any device, arrays, scalars, nested in tuples, lists and dicts).

    Returns True when deterministic; raises AssertionError with the first
    mismatching leaf otherwise.
    """
    ref = [to_host(leaf) for leaf in flatten(fn())]
    for r in range(1, runs):
        out = [to_host(leaf) for leaf in flatten(fn())]
        if len(out) != len(ref):
            raise AssertionError(f"run {r} has {len(out)} leaves, not {len(ref)}")
        for i, (a, b) in enumerate(zip(ref, out)):
            if a.shape != b.shape or not np.array_equal(a, b, equal_nan=True):
                diff = (np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))
                        if a.shape == b.shape else f"shapes {a.shape} / {b.shape}")
                raise AssertionError(f"run {r} leaf {i} differs: max abs diff {diff}")
    return True
