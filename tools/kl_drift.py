#!/usr/bin/env python3
"""MUR KL's f32 routes against float64 on one CUDA card, for one checkout.

    python3 tools/kl_drift.py [--root DIR]

Runs chip_smoke.py's float64 check of MUR KL (``kl_f64_phase``, its gate
off) with the tpunmf_torch package of DIR (default: this checkout), whose
kernels are built from DIR's own ``tpunmf_torch/ops/csrc``: 50 iterations
from one init at 8192 x 8192 r128 (lowrank_dense seed 0, NNDSVD 'zero'),
8192 x 4096 r128 (tfidf_like seed 4) and BASELINE config[1] (20000 x 11000
r50, tfidf_like seed 1), each on the plain route in float64, the plain
route in f32 and the kernel route in f32, and prints each f32 trace's
largest relative distance from the float64 trace.  DIR may be another
commit unpacked with ``git archive`` into a git-ignored directory, or a
copy with an edited kernel source, to compare kernel variants.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kl_drift: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose tpunmf_torch (and kernels) to run")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import tpunmf_torch as tt
    from tpunmf_torch.data import lowrank_dense, tfidf_like
    from tpunmf_torch.init import nndsvd
    from tpunmf_torch.ops import _build

    require_root = os.path.dirname(os.path.dirname(os.path.abspath(tt.__file__)))
    if require_root != root:
        print(f"kl_drift: tpunmf_torch came from {require_root}, not {root}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(f"kl_drift: {root}; {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    eu_x = torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda()
    eu_init = nndsvd(eu_x, 128, variant="zero")
    kl_x = torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()
    kl2_x = torch.from_numpy(tfidf_like(cs.KL_SINGLE["m"], cs.KL_SINGLE["n"],
                                        n_topics=cs.KL_SINGLE["k"],
                                        seed=cs.KL_SINGLE["seed"])).cuda()
    torch.cuda.synchronize()
    print(f"  data and NNDSVD made in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.kl_f64_phase(torch, tt, cs.kl_f64_cases(torch, eu_x, eu_init, kl_x, kl2_x), card,
                    gate=False)
    print(f"  the check took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
