#!/usr/bin/env python3
"""chip_smoke.py's phase 9 alone: MUR across GPUs as a world of one on one card.

    python3 tools/multi_gpu.py

Builds the CUDA kernels and the native panelizer of this checkout, makes
the EU 8192x8192 X (lowrank_dense, seed 0), BASELINE config[1] (tfidf_like,
seed 1), config[3] (sparse_csr, seed 3) and the config[4]-scale CSR
(sparse_csr(1_000_000, 100_000, density=1e-3, seed=0)) as chip_smoke.py
does, and runs ``multi_gpu_phase``: an NCCL group of one rank, the
facade's mesh= and schedule= on (1,) and (1, 1) meshes, the sharded
streamed MUR and sharded serving.  Every number is printed beside the
card's name and power limit; a failure exits non-zero.
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
        print("multi_gpu: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import tpunmf_torch as tt
    import tpunmf_torch.parallel  # noqa: F401  (tt.parallel)
    from tpunmf_torch.data import lowrank_dense, sparse_csr, tfidf_like
    from tpunmf_torch.native import loader, native_available
    from tpunmf_torch.ops import _build, fused, mur_fused, topk_select

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(f"multi_gpu: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()
    cs.require(native_available(), f"the native panelizer did not build: {loader.build_error}")
    print(f"  kernels and panelizer built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    data = {"eu": torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda(),
            "kl": torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()}
    adm_csr = cs.config3_on_card(torch)[1]
    o = cs.OOC
    c4_csr = sparse_csr(o["m"], o["n"], density=o["density"], seed=o["seed"])
    torch.cuda.synchronize()
    print(f"  data made in {time.perf_counter() - t0:.1f} s", flush=True)
    counters = {"mur_w_update": (mur_fused.mur_w_update, "launches"),
                "mur_h_update": (mur_fused.mur_h_update, "launches"),
                "eu_residual_obj": (fused.eu_residual_obj, "launches"),
                "kl_obj": (fused.kl_obj, "launches"), "kl_ratio": (fused.kl_ratio, "launches"),
                "kl_ratio_and_obj": (fused.kl_ratio_and_obj, "launches"),
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
    cs.multi_gpu_phase(torch, tt, drive, card, data, adm_csr, c4_csr)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
