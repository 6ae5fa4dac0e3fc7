#!/usr/bin/env python3
"""chip_smoke.py's phase 9, 10 or 11 alone: the solvers across GPUs as a world of one.

    python3 tools/multi_gpu.py              # phase 9: MUR, streamed MUR, serving
    python3 tools/multi_gpu.py --phase 10   # phase 10: the reference solvers
    python3 tools/multi_gpu.py --phase 11   # phase 11: every other method and keyword

Builds the CUDA kernels and the native panelizer of this checkout, makes
the EU 8192x8192 X (lowrank_dense, seed 0) and BASELINE config[3]'s CSR
(sparse_csr, seed 3) as chip_smoke.py does, and runs a phase.  Phase 9
(``multi_gpu_phase``, with BASELINE config[1] (tfidf_like, seed 1) and the
config[4]-scale CSR (sparse_csr(1_000_000, 100_000, density=1e-3,
seed=0))): an NCCL group of one rank, the facade's mesh= and schedule= on
(1,) and (1, 1) meshes, the sharded streamed MUR and sharded serving.
Phase 10 (``methods_phase``, with the KL 8192x4096 X, tfidf_like seed 4):
hals, anls, admm, ao_admm and masked MUR through the facade's mesh=,
ntf_sharded and the lambda grid's mesh=, each against one device and its
plain route.  Phase 11 (``mesh_rest_phase``, with config[1]): semi_nmf,
onmf, robust, beta=, MUR's objective keywords, multilevel= and ntf through
the facade's mesh=, each against one device and its plain route, and
HALS's checkpoints through both backends.  Every number is printed beside the card's name and power
limit; a failure exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", type=int, choices=(9, 10, 11), default=9)
    phase = parser.parse_args().phase
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
    from tpunmf_torch.ops import _build, fused, hals_sweep, masked_fused, mur_fused, topk_select

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
    eu_x = torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda()
    adm_csr = cs.config3_on_card(torch)[1] if phase != 11 else None
    if phase in (9, 11):
        data = {"eu": eu_x,
                "kl": torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()}
    if phase == 9:
        o = cs.OOC
        c4_csr = sparse_csr(o["m"], o["n"], density=o["density"], seed=o["seed"])
    elif phase == 10:
        k = cs.KL_SINGLE
        data = {"eu": eu_x, "kl": torch.from_numpy(tfidf_like(k["m"], k["n"], n_topics=k["k"],
                                                              seed=k["seed"])).cuda()}
    torch.cuda.synchronize()
    print(f"  data made in {time.perf_counter() - t0:.1f} s", flush=True)
    counters = {"mur_w_update": (mur_fused.mur_w_update, "launches"),
                "mur_h_update": (mur_fused.mur_h_update, "launches"),
                "eu_residual_obj": (fused.eu_residual_obj, "launches"),
                "kl_obj": (fused.kl_obj, "launches"), "kl_ratio": (fused.kl_ratio, "launches"),
                "mur_w_update_lagged": (mur_fused.mur_w_update, "lagged_launches"),
                "mur_iteration_eu": (mur_fused.mur_iteration_eu, "launches"),
                "mur_iteration_kl": (mur_fused.mur_iteration_kl, "launches"),
                "hals_iteration_eu": (hals_sweep.hals_iteration_eu, "launches"),
                "kl_ratio_and_obj": (fused.kl_ratio_and_obj, "launches"),
                "gs_sweep": (hals_sweep.gs_sweep, "launches"),
                "masked_w_update": (masked_fused.masked_w_update, "launches"),
                "masked_h_update": (masked_fused.masked_h_update, "launches"),
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
    if phase == 9:
        cs.multi_gpu_phase(torch, tt, drive, card, data, adm_csr, c4_csr)
    elif phase == 10:
        cs.methods_phase(torch, tt, drive, card, data, adm_csr)
    else:
        cs.mesh_rest_phase(torch, tt, drive, card, data)
    print(f"  phase {phase} took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
