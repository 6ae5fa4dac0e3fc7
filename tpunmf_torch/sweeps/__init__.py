"""The port's counterparts of ``tpunmf``'s scripts under benchmarks/.

``sweep_iter2`` (benchmarks/sweep_iter2.py) and ``sweep_int8``
(benchmarks/sweep_int8.py) drive the EU single-pass variants of
``ops/mur_variants.py`` on the card; ``run_configs``
(benchmarks/run_configs.py) runs BASELINE's five configs to convergence
against the float64 plain route, and ``bench_hals``
(benchmarks/bench_hals.py) times HALS against MUR-EU to an objective:

    python -m tpunmf_torch.sweeps.sweep_iter2
    python -m tpunmf_torch.sweeps.sweep_int8
    python -m tpunmf_torch.sweeps.run_configs [--scale 0.1] [--device cpu]
    python -m tpunmf_torch.sweeps.bench_hals all [out.jsonl] [--device cpu]

Their loops take CPU tensors too (the kernels' plain versions), which is
how the tests drive them; the first two scripts need a CUDA card, the
last two one too unless given ``--device cpu``.
"""
from __future__ import annotations

import subprocess
import time

import torch


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them,
    printed beside every number a script measures."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return f"{out.stdout.strip().splitlines()[0]}; torch {torch.__version__}"


def bench(run, *args, iters: int = 30, reps: int = 3) -> float:
    """Seconds per iteration of ``run(*args, iters)``: the best of ``reps``
    runs, host clock around each, each ending in a host read of its
    result's last element (as the scripts' ``float(...)``), after a warm-up
    run of 2 iterations."""
    def host_read(out):
        return float((out[-1] if isinstance(out, tuple) else out).reshape(-1)[0])

    host_read(run(*args, 2))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        host_read(run(*args, iters))
        best = min(best, time.perf_counter() - t0)
    return best / iters
