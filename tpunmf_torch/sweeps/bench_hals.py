"""Time to objective: HALS against MUR-EU at the headline shape, on the card.

The counterpart of ``tpunmf``'s benchmarks/bench_hals.py.  HALS solves each
rank-1 subproblem exactly, so it needs far fewer iterations than MUR for
the same Euclidean objective; an iteration of either moves about two
passes over X.  This measures seconds to a target objective at 8192 x
8192, rank 128, float32, from one init, 150 iterations with no early stop:

    python -m tpunmf_torch.sweeps.bench_hals all [out.jsonl]
    python -m tpunmf_torch.sweeps.bench_hals mur_eu|hals_s1|hals_s2 [out.jsonl]
    python -m tpunmf_torch.sweeps.bench_hals all out.jsonl --device cpu --shape 256,192,8

Each run is timed twice (the first a warm-up) with the card synchronized
inside the clock, and appends one JSONL record (``name``, ``s_total``,
``it_per_s``, ``shape``, ``obj``).  The data follow the script's recipe:
X = Wt Ht + 0.1 U and the inits W0, H0, all uniform on [0, 1), drawn from
seeded ``torch.Generator``s on the device.  ``jax.random``'s draws cannot be
reproduced in torch, so the matrices are not the script's own.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.precision import full_f32
from ..solvers import hals, mur

M, N, K, ITERS = 8192, 8192, 128, 150

CONFIGS = {
    "mur_eu": (mur, dict(distance_type="eu")),
    "hals_s1": (hals, dict(inner_sweeps=1)),
    "hals_s2": (hals, dict(inner_sweeps=2)),
}


@full_f32()
def problem(m=M, n=N, k=K, *, device="cuda", dtype=torch.float32):
    """(X, W0, H0): X = Wt Ht + 0.1 U from generator seed 0, W0 from seed
    7 and H0 from seed 8 (the script's keys 0, 7 and 8), in ``dtype``."""
    def draw(seed, *shapes):
        g = torch.Generator(device=device).manual_seed(seed)
        return [torch.rand(s, generator=g, device=device, dtype=dtype) for s in shapes]

    wt, ht, u = draw(0, (m, k), (k, n), (m, n))
    x = wt @ ht + 0.1 * u
    (w0,), (h0,) = draw(7, (m, k)), draw(8, (k, n))
    return x, w0, h0


def run(name, x, w0, h0, iters=ITERS):
    """One config ``iters`` iterations from (W0, H0), no early stop:
    (Results, seconds), the device synchronized inside the clock."""
    fn, kw = CONFIGS[name]
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(x, w0.shape[1], w_init=w0, h_init=h0, min_iter=iters,
             max_iter=iters, tol1=0.0, tol2=0.0, **kw)
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def record(name, res, seconds, x, iters=ITERS) -> dict:
    """The script's JSONL record of a measured run."""
    obj = np.asarray(res.obj_history, dtype=np.float64)
    return {"name": name, "s_total": round(seconds, 3), "it_per_s": round(iters / seconds, 1),
            "shape": [int(x.shape[0]), int(x.shape[1]), int(res.w.shape[1])],
            "obj": [float(v) for v in obj]}


def measure(name, x, w0, h0, iters=ITERS) -> dict:
    """A warm-up run, then the measured one: its record."""
    run(name, x, w0, h0, iters)
    res, seconds = run(name, x, w0, h0, iters)
    return record(name, res, seconds, x, iters)


def time_to(rec, target):
    """(iterations, seconds) ``rec``'s run took to reach objective
    ``target``, at its measured rate; None if it never did."""
    hits = np.flatnonzero(np.asarray(rec["obj"]) <= target)
    if hits.size == 0:
        return None
    it = int(hits[0])
    return it, it * rec["s_total"] / (len(rec["obj"]) - 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", choices=[*CONFIGS, "all"])
    ap.add_argument("out", nargs="?", default="bench_hals.jsonl")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the runs go (default: the CUDA card)")
    ap.add_argument("--shape", default=f"{M},{N},{K}", help="m,n,k (default: the script's)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_hals: needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    x, w0, h0 = problem(*(int(v) for v in args.shape.split(",")), device=args.device)
    for name in CONFIGS if args.name == "all" else [args.name]:
        rec = measure(name, x, w0, h0)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(name, rec["s_total"], "s,", rec["it_per_s"], "it/s, final obj",
              f"{rec['obj'][-1]:.6e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
