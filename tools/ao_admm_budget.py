#!/usr/bin/env python3
"""AO-ADMM's local-sparsity variant against its l1 budget, on one CUDA card.

    python3 tools/ao_admm_budget.py [--iters 50]

On chip_smoke.py's EU X (lowrank_dense(8192, 8192, 128, seed=0)) and at
2048 x 2048 (the same recipe), from each X's NNDSVD 'zero' init, runs
``method="ao_admm", rho_mode="adaptive", reg_w=(0.1, "l1inf")`` with the
l1 budget ``upper_bound`` at 1 (tpunmf's default), 64 (the planted W's
mean row norm, k/2) and 256 (above every row of W on these X), in float32
and, at 8192, in float64 (a CUDA float64 tensor: the plain route), and
prints every fourth objective of the trace and the largest row l1 norm of
the final W.  A trace that blows up in float64 as in float32 does so by
the algorithm, not by rounding.  Needs the card; without one it exits
non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ao_admm_budget: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    import chip_smoke as cs
    import tpunmf_torch as tt
    from tpunmf_torch.data import lowrank_dense
    from tpunmf_torch.init import nndsvd

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for m in (8192, 2048):
        x32 = torch.from_numpy(lowrank_dense(m, m, 128, seed=0)).cuda()
        w0, h0 = nndsvd(x32, 128, variant="zero")
        for budget in (1.0, 64.0, 256.0):
            for dtype in ((torch.float32, torch.float64) if m == 8192 else (torch.float32,)):
                t0 = time.perf_counter()
                res = tt.NMF(x32.to(dtype), 128).factorize(
                    method="ao_admm", min_iter=args.iters, max_iter=args.iters,
                    rho_mode="adaptive", reg_w=(0.1, "l1inf"), upper_bound=budget,
                    w_init=w0.to(dtype), h_init=h0.to(dtype))
                trace = np.asarray(res.obj_history, dtype=np.float64)
                rows = np.asarray(res.w, dtype=np.float64).sum(axis=1)
                print(f"  {m}x{m} r128 budget {budget:g} {str(dtype)[6:]}: "
                      f"{time.perf_counter() - t0:.1f} s; objective every 4th "
                      + " ".join(f"{v:.3e}" for v in trace[::4])
                      + f"; final W's largest row l1 norm {np.max(rows):.4g}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
