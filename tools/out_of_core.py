#!/usr/bin/env python3
"""chip_smoke.py's phase 8 alone: out-of-core MUR and topk_streaming on one card.

    python3 tools/out_of_core.py

Builds the CUDA kernels and the native panelizer of this checkout, makes
BASELINE config[3] (sparse_csr, seed 3) and config[1] (tfidf_like, seed 1)
as chip_smoke.py does, and runs ``out_of_core_phase``: the host path's
densify and copy rates, the in-HBM agreements of the streamed runs with
in-core mur, MUR EU at config[4]'s data scale (1M x 100k, 1e8 nonzeros,
r256, bf16 transfer) and topk_streaming from an 8.6 GB host H.  Every
number is printed beside the card's name and power limit; a failure exits
non-zero.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("out_of_core: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from tpunmf_torch.data import tfidf_like
    from tpunmf_torch.ops import _build, fused, topk_select

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(f"out_of_core: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    adm_csr = cs.config3_on_card(torch)[1]
    kl_x = torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()
    torch.cuda.synchronize()
    print(f"  config[3] and config[1] made in {time.perf_counter() - t0:.1f} s", flush=True)
    counters = {"kl_ratio": (fused.kl_ratio, "launches"), "kl_obj": (fused.kl_obj, "launches"),
                "blockmax_relayout": (topk_select.blockmax_relayout, "launches"),
                "score_blockmax_relayout": (topk_select.score_blockmax_relayout, "launches")}

    def drive(label, needed, body, exact=None):
        out, launched = cs.run_path(torch, counters, label, needed, body)
        for name, c in launched.items():
            if exact is not None:
                cs.require(c == exact.get(name, 0),
                           f"{label}: {name} launched {c} times, not {exact.get(name, 0)}")
        return out

    t0 = time.perf_counter()
    cs.out_of_core_phase(torch, drive, card, adm_csr, kl_x)
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
