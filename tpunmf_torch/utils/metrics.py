"""Structured per-block solver metrics, as ``tpunmf.utils.metrics``.

The solvers carry the objective trace as a buffer; this module adds a
host-side sink for blocked execution (objective, iteration rate, achieved
FLOP/s) and helpers that emit them as JSON lines.  ``carry.i`` is an
``int`` and ``carry.obj`` a 0-d CPU tensor.  Where the carry's factors are
on a CUDA device the logger synchronises it before reading the clock:
with ``objective_every > 1`` a block's last iterations read nothing back
to the host, so their kernels may still be running.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import IO, Optional

import numpy as np
import torch

from ..io.checkpoint import flatten


def _cuda_device(carry):
    """The CUDA device of the carry's first CUDA tensor, or None."""
    for leaf in flatten(carry.inner):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


@dataclass
class MetricsLogger:
    """Collects per-block solver progress; use as ``on_block_end``.

    Example:
        logger = MetricsLogger(flops_per_iter=6*m*n*k)
        mur(x, k, block_size=100, on_block_end=logger)
        logger.summary()
    """

    flops_per_iter: Optional[float] = None
    stream: Optional[IO] = None
    records: list = field(default_factory=list)
    _t_last: float = field(default_factory=time.perf_counter)
    _i_last: int = 0

    def __call__(self, carry) -> None:
        device = _cuda_device(carry)
        if device is not None:
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        i = int(carry.i)
        d_i = i - self._i_last
        d_t = now - self._t_last
        rec = {
            "iteration": i,
            "objective": float(carry.obj),
            "converged": bool(carry.converged),
            "iters_per_sec": (d_i / d_t) if d_t > 0 and d_i > 0 else None,
        }
        if self.flops_per_iter and rec["iters_per_sec"]:
            rec["gflops"] = self.flops_per_iter * rec["iters_per_sec"] / 1e9
        self.records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)
        self._t_last, self._i_last = now, i

    def summary(self) -> dict:
        rates = [r["iters_per_sec"] for r in self.records if r["iters_per_sec"]]
        return {
            "iterations": self.records[-1]["iteration"] if self.records else 0,
            "final_objective": self.records[-1]["objective"] if self.records else None,
            "mean_iters_per_sec": float(np.mean(rates)) if rates else None,
        }


def objective_trace_stream(stream: IO = sys.stderr):
    """Minimal on_block_end that mirrors the reference's '[i]: obj' prints
    (nmf/mur.py:128) at block granularity."""

    def cb(carry):
        print(f"[{int(carry.i) - 1}]: {float(carry.obj)}", file=stream)

    return cb
