#!/usr/bin/env python3
"""The kernel routes against float64 on one CUDA card, for one checkout.

    python3 tools/route_drift.py [--root DIR] [--only PREFIX[,PREFIX...]]

Runs chip_smoke.py's float64 check (``route_f64_phase``, phase 6) with the
tpunmf_torch package of DIR (default: this checkout), whose kernels are
built from DIR's own ``tpunmf_torch/ops/csrc``: each case 50 iterations
from one init on the plain route in float64, the plain route in f32 and
the kernel route in f32, and each f32 trace's largest relative distance
from the float64 trace, beside the gate and the card's name and power
limit.  The cases, by key (``--only`` takes the cases whose key starts
with one of its prefixes, e.g. ``--only masked`` or ``--only kl,mur-eu``):

  kl-8192sq, kl-8192x4096, kl-config1   MUR KL (fault 3.5)
  mur-eu, mur-eu-pair, mur-eu-dma       MUR EU 8192^2 r128 on each route
  hals, hals-single                     HALS 8192^2 r128, inner_sweeps=2
  masked-eu-ml10m, masked-kl-ml10m      masked MUR at MovieLens-10M, r64
  masked-eu-8192x4096, masked-kl-8192x4096
                                        masked MUR on KL 8192x4096 r128, 25%

A miss is printed (MISSED), not raised.  DIR may be another
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


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose tpunmf_torch (and kernels) to run")
    ap.add_argument("--only", default="",
                    help="comma-separated prefixes of the case keys to run (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("route_drift: no CUDA device", file=sys.stderr)
        return 2
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

    found = os.path.dirname(os.path.dirname(os.path.abspath(tt.__file__)))
    if found != root:
        print(f"route_drift: tpunmf_torch came from {found}, not {root}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(f"route_drift: {root}; {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    eu_x = torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda()
    eu_init = nndsvd(eu_x, 128, variant="zero")
    hals_init = tuple(f.clamp(min=1e-16).contiguous() for f in eu_init)
    kl_x = torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()
    kl2_x = torch.from_numpy(tfidf_like(cs.KL_SINGLE["m"], cs.KL_SINGLE["n"],
                                        n_topics=cs.KL_SINGLE["k"],
                                        seed=cs.KL_SINGLE["seed"])).cuda()
    ml10_x, ml10_obs = cs.movielens_on_card(torch, *cs.ML10M, seed=3)
    torch.cuda.synchronize()
    print(f"  data and NNDSVD made in {time.perf_counter() - t0:.1f} s", flush=True)
    cases = (cs.kl_f64_cases(torch, eu_x, eu_init, kl_x, kl2_x)
             + cs.eu_f64_cases(torch, eu_x, eu_init, hals_init)
             + cs.masked_f64_cases(torch, "ml10m", f"ML-10M {tuple(ml10_x.shape)}", ml10_x,
                                   ml10_obs, 64)
             + cs.masked_f64_cases(torch, "8192x4096", cs.f64_mask_label(kl2_x), kl2_x,
                                   cs.f64_mask(torch, kl2_x), cs.KL_SINGLE["k"]))
    prefixes = tuple(p for p in args.only.split(",") if p)
    cases = [c for c in cases if not prefixes or c["key"].startswith(prefixes)]
    if not cases:
        print(f"route_drift: no case matches --only {args.only}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cs.route_f64_phase(torch, cs.kernel_counters(), cases, card, gate=False)
    print(f"  the check took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
