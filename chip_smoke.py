#!/usr/bin/env python3
"""Drive tpunmf_torch's main paths once on one CUDA card, through its kernels.

    python3 chip_smoke.py       # one card; about three minutes of command time on an H100

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. the card's name and power limit; build the CUDA kernels of
     tpunmf_torch/ops/csrc with nvcc (sm_90a) and print the build time.
  2. each kernel against its plain PyTorch version on the card, at the
     paths' shapes and ragged ones: the error against a stated tolerance,
     both times (CUDA events, in the order plain, kernel, kernel, plain)
     and the kernel's bound (the larger of its flops over the card's peak
     rate and its bytes over the memory rate).  At EU 8192x8192 r128 (f32
     and bf16 X) and KL 8192x4096 r128 the single-pass iteration is also
     timed against the 2-pass pair, in turns.  The ratio and objective
     passes also run at MUR's high rank, 8192x4096 / 8192x8192 r1536,
     and kl_ratio at ragged 1000x777 k37 and k1100 and at KL config[1];
     mur_h_update, mur_w_update and the lagged W pass also at KL
     8192x4096 r128; the lagged W must be the plain KL W bit for bit, and
     masked_w_update must give the bits it gave before MUR's KL W pass
     came to share its kernel (masked_w_bits).
     The two single passes behind the port's switches: hals_iteration_eu
     at 8192x8192 r128 (f32 at 2 and 1 sweeps, bf16) and ragged 1000x777
     k40, and mur_iteration_eu_dma at 8192x8192 r128 (f32, bf16) and
     ragged k37, which keeps the FMA tiles: at lam_w=0 it is held to
     v1_iter bit for bit, and to mur_iteration_eu (the tensor cores) within
     ROUTE_RTOL, timed against it in turns.  The sweep scripts' kernels:
     v1_iter and v2_iter at 8192x8192 r128 (bf16 and f32 X) and ragged k37,
     v1 held to mur_iteration_eu(lam_w=0) within ROUTE_RTOL and timed
     against it in turns;
     iter_eu_int8 at 8192x8192 r128 (X + 0.05 quantised) and ragged k37;
     the read probe at 8192x8192 f32 and a ragged 896x777, with its rate.
     blockmax_relayout at (64, 2^20) and the read probe at 8192x8192 are
     also timed in turns with the one PyTorch call that computes their
     function (torch.amax of the scores' view, torch.sum over rows), with
     the bytes per second each reaches.  The tensor-core kernels
     (mur_iteration_eu, mur_w_update, the lagged W pass and mur_h_update
     at their shapes above, both masked passes at MovieLens-1M and -10M;
     kl_ratio_and_obj and kl_ratio at config[3], config[1] and r1536;
     eu_residual_obj at 8192x8192 r128, r1536 and config[3]; kl_obj at
     config[1], 8192x4096 r128 and r1536)
     also print their profiler device time and the TFLOP/s of f32 products
     (TB/s where bytes bind) alone, on the device and at the bound; both
     masked passes also run on bf16 X at MovieLens-10M and must give the
     same bits on a second call, and kl_ratio's ratio and kl_obj's
     objective must be kl_ratio_and_obj's bit for bit at every KL shape.
  3. the paths through tpunmf_torch.NMF(...).factorize, exactly 50
     iterations each, the kernel route against the plain route on the card:
     - MUR: EU at 8192x8192 r128 (lowrank_dense) with bf16 and f32 X, which
       tpunmf's route rule sends to the single pass, and the same runs on
       the 2-pass pair for comparison; EU f32 at 8192x16384 r128, which the
       rule sends to the 2-pass pair; KL at its defaults (random init,
       exact objective) on BASELINE config[1], 20000x11000 r50 (tfidf_like,
       seed 1), 2-pass; KL at 8192x4096 r128 (tfidf_like, seed 4), single
       pass, exact and objective="lagged"; after the paths, the EU and KL
       single-pass shapes, config[1] and the high-rank step profiled on
       both routes;
     - MUR's high-rank step (1024 < k <= 2048: plain products, the
       ratio and objective kernels): KL at 8192x4096 and EU at 8192x8192,
       both r1536; KL must launch kl_ratio 50 times and kl_ratio_and_obj
       51, EU eu_residual_obj 51, and neither an update kernel;
     - NMF given float64 numpy arrays (they run on the card as float32,
       through their routes' kernels): MUR EU and KL at 8192x8192 r128,
       and mask=, HALS and ADMM at 1000x777 r37; and a CUDA float64 tensor
       (the plain route: no kernel launched);
     - HALS (method="hals"): EU 8192x8192 r128 f32, inner_sweeps=2, from
       one NNDSVD 'zero' init given to both routes;
     - masked MUR (mask=): EU and KL at MovieLens-10M's dimensions, 69878
       users x 10677 items, 1.34% observed, r64 (movielens_like's recipe,
       made on the card; profiled on both routes after the paths);
     - MUR KL with objective="lagged" at config[1] and at 8192x4096, each
       against its exact run;
     - serving (tpunmf_torch.serve.topk): 20 batches of 64 users against
       n = 2^20 items at r128, k = 100, exact, quantized (bf16 first stage
       from a stored bf16 H) and exact with 1% of the items excluded, and
       20 batches at r512, n = 2^19, exact; kernel route against the plain
       route (the same code with the kernels' plain versions), each
       answer held against a stable sort of its own scores, and after
       the path, each mode's device and wall ms per request from a profile
       of 10 requests on each route;
     - ADMM (method="admm") at BASELINE config[3], 50000x20000 r128
       (sparse_csr(density=0.02, seed=3) densified), EU with rho fixed and
       adaptive, and KL (EU and KL profiled on both routes after the path);
     - the switched single passes (tpunmf_torch/solvers/cuda_defaults.py,
       off by default as in tpunmf, flipped by switched()): HALS at
       8192x8192 r128 f32 with hals_single_pass on, and MUR EU at the same
       X, f32 and bf16, with mur_single_pass_variant "dma", each from its
       default run's init and held to that run's trace, with profiles.
     - the sweep scripts' paths (tpunmf_torch/sweeps), at their 8192x8192
       r128 from their own recipes, 30 iterations each: the v1 and v2
       loops on bf16 X from one init (exactly 30 v1_iter, 30 v2_iter, no
       other kernel; their results agree within the bf16 route tolerance),
       the tensor-core probe, and the int8 loop against the f32 single-pass
       loop (exactly 30 iter_eu_int8 and 30 mur_iteration_eu) with the
       objective's relative deviation; and the read rate of the 8192x8192
       f32 X by the read probe (exactly 360 launches).
     Each path's launch counters are set to 0 just before it and read just
     after; each run must launch its route's kernels and none of the other
     route's, and give finite factors and trace (non-increasing for MUR and
     HALS EU; ADMM's is not monotone).  The paths with the switches at their
     defaults must launch neither switched kernel, and no NMF.factorize
     path may launch a sweep script's kernel or the read probe.
  4. a save_factorization / load_factorization round trip.
Then one JSON line of the kernels, the nvidia-smi line, and the result
line.  Without a CUDA card, or without the tpunmf_torch package beside
this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain version.  Both round the same operands to the same types,
# and every sum in the updates is of positive terms, so the elementwise error
# is f32 rounding of sums taken in another order: about sqrt(n) * 6e-8
# typically, n * 6e-8 = 1.2e-3 at worst for n = 20000.  The objectives are
# sums of up to 2.2e8 cells, again in another order.
UPDATE_RTOL = 1e-4
OBJECTIVE_RTOL = 1e-4
# Fused route vs plain route over the first iterations of a run.  f32 X: the
# same formulas in another summation order.  bf16 X: the fused EU products
# also round the factor to bf16 (tpunmf mur_fused.py:84, :716), which the
# plain route does not, so the two routes differ by bf16 rounding (2^-9).
ROUTE_RTOL = {"float32": 1e-4, "bfloat16": 5e-3}
ROUTE_ITERS = 5
RUN_ITERS = 50
# EU objective may not rise by more than f32 rounding between iterations
EU_MONOTONE_RTOL = 1e-5
# HALS sweeps clamp at 0, so an element's relative error means nothing
# near a clamp: the sweep is held to max|got - want| / max|want|
SWEEP_TOL = 1e-4
# hals_iteration_eu against its plain version, on the same scale: the kernel
# forms X round(H)^T itself (FMA tiles) where the plain version takes cuBLAS's,
# another f32 summation order, and each Gauss-Seidel step subtracts sums up
# to k times larger than their difference, so that rounding comes out
# amplified (1.6e-4 measured at 8192x8192 r128 with random factors)
HALS_ITER_TOL = 1e-3
# lagged[i+1] against the exact route's exact[i]: the same KL sums, one
# from the W pass's tiles and one from the objective kernel's
LAGGED_RTOL = 1e-4
# MovieLens-10M: 10,000,054 ratings of 69,878 users on 10,677 items
ML10M = (69878, 10677, 0.0134)
# BASELINE config[3] (benchmarks/run_configs.py:176-188): ADMM, L1 on H
CONFIG3 = dict(m=50000, n=20000, k=128, density=0.02, seed=3)
ADMM_KW = dict(rho=1.0, reg_w=(0, "nn"), reg_h=(0.1, "l1n"),
               nndsvd_init=(True, "zero"))
# the fused scoring kernel against its plain version: both accumulate the
# same f32 products in another order; |got - want| <= 2e-5 (1 + |want|),
# tpunmf's tolerance against interpret mode (tests/test_serve.py:456-459)
SCORE_TOL = 2e-5
# serving: top-k values of the kernel and plain routes (scores summed in
# another order), relative
SERVE_VALUE_RTOL = 1e-5
SERVE_BATCH, SERVE_BATCHES, SERVE_K = 64, 20, 100
# calls of a kernel and of its library call that the profiler times
PROFILED_CALLS = 20

# masked_w_bits as the masked W pass gave them on an H100 before MUR's KL W
# pass came to share its kernel: the bits it must keep
MASKED_W_BITS = "7cdbaf0dd25264455ec0e6c7d08771d51db7fed38144b35f800e60027f0d8e97"
# the single-pass shapes: tpunmf's own route test (tests/test_ops.py:265-277)
KL_SINGLE = dict(m=8192, n=4096, k=128, seed=4)
EU_WIDE = dict(m=8192, n=16384, k=128, seed=0)
SINGLE_EU = ("mur_iteration_eu", "eu_residual_obj")
PAIR = ("mur_w_update", "mur_h_update")
UPDATES = PAIR + ("mur_iteration_eu", "mur_iteration_kl")
# MUR's high-rank step: above the update kernels' 1024, within the
# objective kernels' 2048 (tpunmf takes its jnp step with the ratio and
# objective kernels there, tpunmf/solvers/mur.py:256-280)
HIGH_RANK = 1536

KERNELS = {
    "mur_w_update": ("tpunmf_torch/ops/csrc/mur_update.cu",
                     "tpunmf/ops/mur_fused.py:169"),
    "mur_h_update": ("tpunmf_torch/ops/csrc/mur_update.cu",
                     "tpunmf/ops/mur_fused.py:750"),
    "eu_residual_obj": ("tpunmf_torch/ops/csrc/objective.cu",
                        "tpunmf/ops/fused.py:233"),
    "kl_obj": ("tpunmf_torch/ops/csrc/objective.cu", "tpunmf/ops/fused.py:220"),
    "mur_w_update_lagged": ("tpunmf_torch/ops/csrc/mur_update.cu",
                            "tpunmf/ops/mur_fused.py:227"),
    "gs_sweep": ("tpunmf_torch/ops/csrc/hals_sweep.cu",
                 "tpunmf/ops/hals_sweep.py:232"),
    "masked_w_update": ("tpunmf_torch/ops/csrc/masked_update.cu",
                        "tpunmf/ops/masked_fused.py:129"),
    "masked_h_update": ("tpunmf_torch/ops/csrc/masked_update.cu",
                        "tpunmf/ops/masked_fused.py:224"),
    "kl_ratio_and_obj": ("tpunmf_torch/ops/csrc/objective.cu",
                         "tpunmf/ops/fused.py:253"),
    "blockmax_relayout": ("tpunmf_torch/ops/csrc/topk_select.cu",
                          "tpunmf/ops/topk_select.py:77"),
    "score_blockmax_relayout": ("tpunmf_torch/ops/csrc/topk_select.cu",
                                "tpunmf/ops/topk_select.py:156"),
    "mur_iteration_eu": ("tpunmf_torch/ops/csrc/mur_iteration.cu",
                         "tpunmf/ops/mur_fused.py:314"),
    "mur_iteration_kl": ("tpunmf_torch/ops/csrc/mur_iteration.cu",
                         "tpunmf/ops/mur_fused.py:652"),
    "kl_ratio": ("tpunmf_torch/ops/csrc/objective.cu", "tpunmf/ops/fused.py:243"),
    "mur_iteration_eu_dma": ("tpunmf_torch/ops/csrc/mur_iteration.cu",
                             "tpunmf/ops/mur_fused.py:465"),
    "hals_iteration_eu": ("tpunmf_torch/ops/csrc/hals_iteration.cu",
                          "tpunmf/ops/hals_sweep.py:186"),
    "v1_iter": ("tpunmf_torch/ops/csrc/mur_variants.cu", "benchmarks/sweep_iter2.py:38"),
    "v2_iter": ("tpunmf_torch/ops/csrc/mur_variants.cu", "benchmarks/sweep_iter2.py:92"),
    "iter_eu_int8": ("tpunmf_torch/ops/csrc/mur_variants.cu", "benchmarks/sweep_int8.py:49"),
    "read_probe": ("tpunmf_torch/ops/csrc/read_probe.cu", "bench.py:240"),
}
# the kernels that only the port's switches reach (tpunmf's defaults: off)
OPT_IN = ("mur_iteration_eu_dma", "hals_iteration_eu")
# the kernels of the sweep scripts and of the read-rate probe, which no
# NMF.factorize path may launch
SWEEP_ONLY = ("v1_iter", "v2_iter", "iter_eu_int8", "read_probe")
SWEEP_ITERS = 30  # the sweep scripts' loops (benchmarks/sweep_iter2.py:123)
# the shape whose times the kernels line reports (its f32 case, or X's
# type in HEADLINE_X: the sweep scripts' own)
HEADLINE = {"kl_obj": "KL", "mur_w_update_lagged": "KL",
            "masked_w_update": "ML-10M", "masked_h_update": "ML-10M",
            "kl_ratio_and_obj": "config[3]", "blockmax_relayout": "serve",
            "score_blockmax_relayout": "serve", "mur_iteration_kl": "KL",
            "kl_ratio": "high-rank KL"}
HEADLINE_X = {"v1_iter": "bf16", "v2_iter": "bf16", "iter_eu_int8": "int8"}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_pair(torch, plain, kernel, reps):
    """(kernel_ms, plain_ms): CUDA-event means, in turns plain, kernel,
    kernel, plain after one warm-up call of each."""
    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    plain()
    kernel()
    p1, k1, k2, p2 = timed(plain), timed(kernel), timed(kernel), timed(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(torch, fn, calls):
    """Device ms per call of ``fn`` over ``calls`` calls: the time of its
    kernels in torch.profiler, with no host time between them inside.
    Where the profiler shows no device time (its tracing is not always
    there), CUDA events around ``calls`` calls back to back instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us > 0:
        return us / 1e3 / calls
    print(f"  (the profiler showed no device time: CUDA events over {calls} calls)",
          flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def chunks(got, want, size=1 << 26):
    """(got, want) as float64 pieces of at most ``size`` elements, so that
    comparing two config[3]-sized outputs (1e9 cells) needs no 8 GB
    temporaries."""
    for a, b in zip(got.reshape(-1).split(size), want.reshape(-1).split(size)):
        yield a.double(), b.double()


def max_rel_err(got, want):
    tiny = float(np.finfo(np.float32).tiny)
    return max(float(((a - b).abs() / b.abs().clamp_min(tiny)).max())
               for a, b in chunks(got, want))


def scaled_err(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def close_err(got, want):
    """max |got - want| / (1 + |want|): against t, rtol = atol = t."""
    return max(float(((a - b).abs() / (1.0 + b.abs())).max())
               for a, b in chunks(got, want))


def bit_err(got, want):
    """0 when the tensors hold the same values with NaN in the same places,
    else the largest difference (inf where only one side is NaN)."""
    import torch

    worst = 0.0
    for a, b in chunks(got, want):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return float("inf")
        real = ~torch.isnan(b)
        worst = max(worst, float((a[real] - b[real]).abs().max()))
    return worst


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def written(outputs, inputs):
    """The outputs whose bytes a call writes: one that shares an input's
    storage (a view of it) writes none."""
    shared = {t.untyped_storage().data_ptr() for t in inputs}
    return [o for o in outputs if o.untyped_storage().data_ptr() not in shared]


def mur_flops(name, x, k, dist=None):
    """(f32, bf16) flops of one call of a MUR kernel on X at rank k."""
    import torch
    from tpunmf_torch.ops import roofline

    return roofline.mur_flops(name, *x.shape, k, x.dtype == torch.bfloat16, dist)


def check_kernel(torch, records, name, label, what, kern, plain, rtol, reps,
                 err=max_rel_err, inputs=(), flops=(0.0, 0.0, 0.0), library=None,
                 profiled=False):
    """One kernel call against its plain version on the same inputs: the
    error (over every output) against rtol, both times, the bound of the
    call (tpunmf_torch/ops/roofline.py: ``inputs`` read once, the outputs
    that are not views of an input written once, ``flops`` (f32
    elementwise, bf16 product, f32 product) done), and where one PyTorch
    call computes the same function (``library``), that call's time in
    turns with the kernel's (library, kernel, kernel, library; ``reps``
    calls a run, as ``ms``), both device times (profiler), and the bytes
    per second of each.  ``profiled``: the kernel's device time (profiler)
    too, and the rate it reaches on what binds it (TFLOP/s of its products
    where operations do, TB/s where bytes do), alone and on the device."""
    from tpunmf_torch.ops import roofline

    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rel = max(err(a, b) for a, b in zip(got, want))
    abs_err = max(bit_err(a, b) for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ms, plain_ms = time_pair(torch, plain, kern, reps)
    moved = nbytes(inputs) + nbytes(written(got, inputs))
    library_ms = turns_ms = kern_dev = lib_dev = None
    if library is not None:
        turns_ms, library_ms = time_pair(torch, library, kern, reps)
        kern_dev, lib_dev = (device_ms(torch, f, PROFILED_CALLS) for f in (kern, library))
    elif profiled:
        kern_dev = device_ms(torch, kern, PROFILED_CALLS)
    f32_flops, bf16_flops, product_flops = flops
    bound_ms, bound_by = roofline.bound(f32_flops, bf16_flops, moved, product_flops)
    ok = finite and rel <= rtol
    print(f"  {name:19s} {label:36s} {what:24s} err={rel:.3e} "
          f"(tol {rtol:.0e}) max_abs_err={abs_err:.3e} "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
          f"({bound_by})  {'ok' if ok else 'FAIL'}", flush=True)
    if library is not None:
        print(f"  {name:19s} {label:36s} in turns with the library call, {reps} calls "
              f"a run, on {moved / 1e6:.1f} MB: kernel {turns_ms:.4f} ms "
              f"({moved / turns_ms / 1e9:.3f} TB/s), library {library_ms:.4f} ms "
              f"({moved / library_ms / 1e9:.3f} TB/s); device time (profiler, "
              f"{PROFILED_CALLS} calls) kernel {kern_dev:.4f} ms "
              f"({moved / kern_dev / 1e9:.3f} TB/s), library {lib_dev:.4f} ms "
              f"({moved / lib_dev / 1e9:.3f} TB/s)", flush=True)
    rates = None
    if profiled:
        # TFLOP/s of f32 products (or of all flops) where operations bind,
        # TB/s where bytes do; both per ms: work / 1e9 / ms
        work, unit = ((product_flops or f32_flops + bf16_flops, "TFLOP/s")
                      if bound_by == "operations" else (moved, "TB/s"))
        rates = {"unit": unit, "alone": work / ms / 1e9, "device": work / kern_dev / 1e9,
                 "bound": work / bound_ms / 1e9}
        print(f"  {name:19s} {label:36s} device time (profiler, {PROFILED_CALLS} calls) "
              f"{kern_dev:.4f} ms; {unit} alone {rates['alone']:.3f}, on the device "
              f"{rates['device']:.3f}, at the bound {rates['bound']:.3f} "
              f"({product_flops / 1e9:.1f} GFLOP of f32 products, {moved / 1e6:.1f} MB)",
              flush=True)
    require(finite, f"{name} {label} {what}: non-finite output")
    require(rel <= rtol, f"{name} {label} {what}: error {rel:.3e} above {rtol:.0e}")
    rec = records.setdefault(name, {"max_abs_err": 0.0, "cases": []})
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    rec["cases"].append({"shape": label, "case": what, "max_rel_err": rel,
                         "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                         "library_ms": library_ms, "turns_ms": turns_ms,
                         "device_ms": kern_dev, "library_device_ms": lib_dev,
                         "rates": rates})


def kernel_phase(torch, cases, reps, records=None):
    """Compare every kernel of the MUR path with its plain version (a case
    may name the kernels it takes); returns per-kernel records, with the
    pair's device times and rates (tensor-core kernels).  Launches here do
    not count toward a path's."""
    from tpunmf_torch.ops import fused, mur_fused

    records = {} if records is None else records
    for label, x, k, distances, *only in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(7)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        checks = []
        for dist in distances:
            for lam in (0.0, 0.2):
                checks.append((
                    "mur_w_update", dist, f"{dist} lam={lam}",
                    lambda d=dist, l=lam: mur_fused.mur_w_update(
                        x, w, h, distance_type=d, lam=l),
                    lambda d=dist, l=lam: mur_fused.mur_w_update_ref(
                        x, w, h, distance_type=d, lam=l), UPDATE_RTOL))
                checks.append((
                    "mur_h_update", dist, f"{dist} lam={lam}",
                    lambda d=dist, l=lam: mur_fused.mur_h_update(
                        x, w, h, distance_type=d, lam=l),
                    lambda d=dist, l=lam: mur_fused.mur_h_update_ref(
                        x, w, h, distance_type=d, lam=l), UPDATE_RTOL))
            obj = "eu_residual_obj" if dist == "eu" else "kl_obj"
            checks.append((obj, dist, dist, lambda o=obj: getattr(fused, o)(x, w, h),
                           lambda o=obj: getattr(fused, o + "_ref")(x, w, h),
                           OBJECTIVE_RTOL))
        for name, dist, what, kern, plain, rtol in checks:
            if only and name not in only[0]:
                continue
            check_kernel(torch, records, name, label, what, kern, plain, rtol, reps,
                         inputs=(x, w, h), flops=mur_flops(name, x, k, dist),
                         profiled=name in PAIR)
        del w, h
    return records


def lagged_phase(torch, records, x, k, label, reps):
    """The lagged W pass against its plain version: the new W, and the
    objective against the plain masked KL of the incoming (W, H) (the
    formula of fused.kl_obj_ref), with its device time; its W must be the
    plain KL W pass's bit for bit."""
    from tpunmf_torch.ops import mur_fused

    m, n = x.shape
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    w = torch.rand((m, k), generator=g, device="cuda") + 0.1
    h = torch.rand((k, n), generator=g, device="cuda") + 0.1
    for lam in (0.0, 0.2):
        kw = dict(distance_type="kl", lam=lam, with_lagged_obj=True)
        check_kernel(torch, records, "mur_w_update_lagged", label, f"kl lam={lam}",
                     lambda: mur_fused.mur_w_update(x, w, h, **kw),
                     lambda: mur_fused.mur_w_update_ref(x, w, h, **kw),
                     UPDATE_RTOL, reps, inputs=(x, w, h),
                     flops=mur_flops("mur_w_update_lagged", x, k, "kl"), profiled=True)
        got = mur_fused.mur_w_update(x, w, h, **kw)[0]
        require(torch.equal(got, mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=lam)),
                f"mur_w_update_lagged {label}: its W is not the plain KL W pass's")


def masked_w_bits(torch, mf):
    """sha256 of masked_w_update's outputs on fixed inputs made from a seed:
    EU and KL, lam 0.2, f32 and bf16 X, a uint8 mask with a cold row and
    column, at 300x277 k37 (32-row blocks, H through its padded copy) and
    17000x260 k64 (64-row blocks, H in place)."""
    import hashlib

    digest = hashlib.sha256()
    for m, n, k in ((300, 277, 37), (17000, 260, 64)):
        rng = np.random.default_rng(m + n + k)
        x = rng.random((m, n), dtype=np.float32)
        mask = (rng.random((m, n)) < 0.3).astype(np.uint8)
        mask[3, :] = 0
        mask[:, 5] = 0
        w = (rng.random((m, k)) + 0.1).astype(np.float32)
        h = (rng.random((k, n)) + 0.1).astype(np.float32)
        xc, mc, wc, hc = (torch.from_numpy(a).cuda() for a in (x, mask, w, h))
        for xx in (xc, xc.bfloat16()):
            for dist in ("eu", "kl"):
                out = mf.masked_w_update(xx, mc, wc, hc, distance_type=dist, lam=0.2)
                digest.update(out.cpu().numpy().tobytes())
    return digest.hexdigest()


def iteration_phase(torch, records, cases, reps):
    """mur_iteration_eu / mur_iteration_kl against their plain versions
    (every output, KL's objective too, within UPDATE_RTOL: f32 sums of
    positive terms in another order), and where ``pair`` is set the single
    pass against the 2-pass pair (mur_w_update + mur_h_update) on the same
    inputs, timed in turns (pair, single, single, pair); returns those
    times."""
    from tpunmf_torch.ops import mur_fused

    routes = {}
    for label, x, k, dist, pair in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(14)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        name = "mur_iteration_" + dist
        tileable = mur_fused.iter_eu_tileable if dist == "eu" else mur_fused.iter_kl_tileable
        route = tileable(x, k)
        # tpunmf's strip height where its rule gives one, else one strip
        bm = m if route is None else route if dist == "eu" else route[0]
        kern, ref = getattr(mur_fused, name), getattr(mur_fused, name + "_ref")
        for lam in (0.0, 0.2):
            check_kernel(torch, records, name, label, f"{dist} lam={lam} bm={bm}",
                         lambda l=lam: kern(x, w, h, lam_w=l, bm=bm),
                         lambda l=lam: ref(x, w, h, lam_w=l), UPDATE_RTOL, reps,
                         inputs=(x, w, h), flops=mur_flops(name, x, k),
                         profiled=dist == "eu")
        if pair:
            def two_pass():
                w1 = mur_fused.mur_w_update(x, w, h, distance_type=dist, lam=0.0)
                return mur_fused.mur_h_update(x, w1, h, distance_type=dist, lam=0.0)

            single_ms, pair_ms = time_pair(torch, two_pass,
                                           lambda: kern(x, w, h, lam_w=0.0, bm=bm), reps)
            routes[label] = {"single_ms": single_ms, "pair_ms": pair_ms}
            print(f"  {label}: single pass {single_ms:.4f} ms, 2-pass pair "
                  f"{pair_ms:.4f} ms (mur_w_update + mur_h_update, in turns)", flush=True)
        del w, h
    return routes


def sweep_phase(torch, records, cases, reps):
    """gs_sweep against its plain version in the W frame (transposed
    views) and the H frame."""
    from tpunmf_torch.ops import hals_sweep

    for label, x, k in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(9)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        frames = {"W frame": ((x @ h.T).T, h @ h.T, w.T),
                  "H frame": (w.T @ x, w.T @ w, h)}
        for frame, (a, gram, v) in frames.items():
            for lam in (0.0, 0.3):
                for nsweeps in (1, 2):
                    kw = dict(lam=lam, nsweeps=nsweeps)
                    # each sweep updates every entry of V from a row of the Gram
                    check_kernel(torch, records, "gs_sweep", label,
                                 f"{frame} lam={lam} sweeps={nsweeps}",
                                 lambda: hals_sweep.gs_sweep(a, gram, v, **kw),
                                 lambda: hals_sweep.gs_sweep_ref(a, gram, v, **kw),
                                 SWEEP_TOL, reps, err=scaled_err, inputs=(a, gram, v),
                                 flops=(2.0 * k * k * v.shape[1] * nsweeps, 0.0, 0.0))
        del w, h, frames


def opt_in_phase(torch, records, eu_x, k, ragged, reps):
    """hals_iteration_eu (HALS_ITER_TOL, scaled: the sweeps clamp) and
    mur_iteration_eu_dma (UPDATE_RTOL) against their plain versions; the
    dma variant (FMA tiles) at lam_w=0 against v1_iter (the same FMAs in
    the same order): the same outputs bit for bit; and against
    mur_iteration_eu (the tensor cores): within ROUTE_RTOL, timed in turns
    (auto, dma, dma, auto).  Returns those times."""
    from tpunmf_torch.ops import hals_sweep, mur_fused, mur_variants, roofline

    g = torch.Generator(device="cuda")
    g.manual_seed(15)

    def factors(m, n, kk):
        return (torch.rand((m, kk), generator=g, device="cuda") + 0.1,
                torch.rand((kk, n), generator=g, device="cuda") + 0.1)

    eu, rag = f"EU {tuple(eu_x.shape)} k{k}", f"ragged {tuple(ragged.shape)}"
    # the HALS path's 2 sweeps first: the kernels line reports the first case
    for label, x, kk, nsweeps, lam in (
            (f"{eu} f32", eu_x, k, 2, 0.0), (f"{eu} f32", eu_x, k, 1, 0.0),
            (f"{eu} bf16", eu_x.bfloat16(), k, 2, 0.0),
            (f"{rag} k40 f32", ragged, 40, 2, 0.3),
            (f"{rag} k40 bf16", ragged.bfloat16(), 40, 2, 0.3)):
        m, n = x.shape
        w, h = factors(m, n, kk)
        bm = hals_sweep.hals_iter_tileable(x, kk) or m  # tpunmf's strips, else one
        kw = dict(lam_w=lam, nsweeps=nsweeps)
        check_kernel(torch, records, "hals_iteration_eu", label,
                     f"lam={lam} sweeps={nsweeps} bm={bm}",
                     lambda: hals_sweep.hals_iteration_eu(x, w, h, bm=bm, **kw),
                     lambda: hals_sweep.hals_iteration_eu_ref(x, w, h, **kw),
                     HALS_ITER_TOL, reps, err=scaled_err, inputs=(x, w, h),
                     flops=roofline.hals_flops(m, n, kk, x.dtype == torch.bfloat16, nsweeps))
        del w, h
    line = {}
    for label, x, kk in ((f"{eu} f32", eu_x, k), (f"{eu} bf16", eu_x.bfloat16(), k),
                         (f"{rag} k37 f32", ragged, 37),
                         (f"{rag} k37 bf16", ragged.bfloat16(), 37)):
        m, n = x.shape
        w, h = factors(m, n, kk)
        # tpunmf's strip heights where its rules give one, else two strips / one
        bm = mur_fused.iter_eu_dma_tileable(x, kk) or m // 2
        auto_bm = mur_fused.iter_eu_tileable(x, kk) or m
        for lam in (0.0, 0.2):
            check_kernel(torch, records, "mur_iteration_eu_dma", label, f"eu lam={lam} bm={bm}",
                         lambda l=lam: mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=l, bm=bm),
                         lambda l=lam: mur_fused.mur_iteration_eu_dma_ref(x, w, h, lam_w=l),
                         UPDATE_RTOL, reps, inputs=(x, w, h),
                         flops=mur_flops("mur_iteration_eu_dma", x, kk))
        dma = mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.2, bm=bm)
        auto = mur_fused.mur_iteration_eu(x, w, h, lam_w=0.2, bm=auto_bm)
        rel = max(max_rel_err(a, b) for a, b in zip(dma, auto))
        rtol = ROUTE_RTOL[str(x.dtype).split(".")[-1]]
        v1_bm = 128 if x.shape[0] % 128 == 0 else 8  # the sweep scripts' strips
        v1 = mur_variants.v1_iter(x, w, h, bm=v1_bm)
        dma0 = mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.0, bm=bm)
        diff = max(bit_err(a, b) for a, b in zip(dma0, v1))
        dma_ms, auto_ms = time_pair(
            torch, lambda: mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=auto_bm),
            lambda: mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.0, bm=bm), reps)
        line[label] = {"dma_ms": dma_ms, "auto_ms": auto_ms, "max_rel_diff": rel,
                       "max_abs_diff_v1": diff}
        print(f"  {label}: mur_iteration_eu_dma {dma_ms:.4f} ms, mur_iteration_eu "
              f"{auto_ms:.4f} ms (in turns); max relative |dma - auto| {rel:.3e} "
              f"(tol {rtol:.0e}); max |dma - v1_iter| at lam_w=0 {diff:.3e}", flush=True)
        require(rel <= rtol, f"{label}: the dma variant and mur_iteration_eu differ by "
                             f"{rel:.3e}")
        require(diff == 0.0, f"{label}: the dma variant (lam_w=0) and v1_iter differ")
        del w, h, dma, auto, dma0, v1
    return line


def variant_phase(torch, records, eu_x, k, ragged, reps):
    """The sweep scripts' kernels against their plain versions (UPDATE_RTOL:
    sums of positive terms in another order): v1_iter and v2_iter at the
    scripts' 8192x8192 r128 on bf16 X and on f32 X and at ragged k37, v1
    also against mur_iteration_eu(lam_w=0) on the same inputs (FMA tiles
    against the tensor cores) within ROUTE_RTOL, timed in turns (auto, v1,
    v1, auto); iter_eu_int8 on X + 0.05 quantised
    as sweep_int8.py does and on the ragged X; and the read probe at 8192x8192
    f32 (268 MB, past the 50 MB L2) with torch.sum(x, 0) as its library call,
    and at a ragged 896x777 (n % 4 != 0).  Returns the v1 / auto times."""
    from tpunmf_torch.ops import mur_fused, mur_variants, read_probe, roofline
    from tpunmf_torch.sweeps import sweep_int8

    g = torch.Generator(device="cuda")
    g.manual_seed(16)

    def factors(m, n, kk):
        return (torch.rand((m, kk), generator=g, device="cuda") + 0.1,
                torch.rand((kk, n), generator=g, device="cuda") + 0.1)

    eu, rag = f"EU {tuple(eu_x.shape)} k{k}", f"ragged {tuple(ragged.shape)} k37"
    line = {}
    # the scripts' bf16 X first: the kernels line reports the first case
    for label, x, kk, bm in ((f"{eu} bf16", eu_x.bfloat16(), k, 128), (f"{eu} f32", eu_x, k, 128),
                             (f"{rag} f32", ragged, 37, 8), (f"{rag} bf16", ragged.bfloat16(), 37, 8)):
        m, n = x.shape
        w, h = factors(m, n, kk)
        for name in ("v1_iter", "v2_iter"):
            kern, ref = getattr(mur_variants, name), getattr(mur_variants, name + "_ref")
            check_kernel(torch, records, name, label, f"eu lam=0 bm={bm}",
                         lambda: kern(x, w, h, bm), lambda: ref(x, w, h), UPDATE_RTOL, reps,
                         inputs=(x, w, h), flops=mur_flops(name, x, kk))
        auto_bm = mur_fused.iter_eu_tileable(x, kk) or m
        v1 = mur_variants.v1_iter(x, w, h, bm)
        auto = mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=auto_bm)
        rel = max(max_rel_err(a, b) for a, b in zip(v1, auto))
        rtol = ROUTE_RTOL[str(x.dtype).split(".")[-1]]
        v1_ms, auto_ms = time_pair(
            torch, lambda: mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=auto_bm),
            lambda: mur_variants.v1_iter(x, w, h, bm), reps)
        line[label] = {"v1_ms": v1_ms, "auto_ms": auto_ms, "max_rel_diff": rel}
        print(f"  {label}: v1_iter {v1_ms:.4f} ms, mur_iteration_eu(lam_w=0) {auto_ms:.4f} ms "
              f"(in turns); max relative |v1 - auto| {rel:.3e} (tol {rtol:.0e})", flush=True)
        require(rel <= rtol, f"{label}: v1_iter and mur_iteration_eu(lam_w=0) differ by "
                             f"{rel:.3e}")
        del w, h, v1, auto
    for label, x, kk, bm in ((f"{eu} int8", eu_x + 0.05, k, 128), (f"{rag} int8", ragged, 37, 8)):
        m, n = x.shape
        w, h = factors(m, n, kk)
        xq, scale = sweep_int8.quantize(x)
        check_kernel(torch, records, "iter_eu_int8", label, f"eu lam=0 bm={bm}",
                     lambda: mur_variants.iter_eu_int8(xq, scale, w, h, bm),
                     lambda: mur_variants.iter_eu_int8_ref(xq, scale, w, h), UPDATE_RTOL, reps,
                     inputs=(xq, scale, w, h), flops=mur_flops("iter_eu_int8", xq, kk))
        del w, h, xq
    s = torch.tensor(0.5, device="cuda")
    for label, x in ((f"EU {tuple(eu_x.shape)} f32", eu_x),
                     ("ragged (896, 777) f32", ragged[:896].contiguous())):
        library = (lambda: torch.sum(x, dim=0)) if x is eu_x else None
        check_kernel(torch, records, "read_probe", label, "s=0.5",
                     lambda: read_probe.read_probe(x, s), lambda: read_probe.read_probe_ref(x, s),
                     UPDATE_RTOL, reps, inputs=(x, s), flops=roofline.read_probe_flops(*x.shape),
                     library=library)
    probe = records["read_probe"]["cases"][0]
    print(f"  read probe {tuple(eu_x.shape)} f32: {nbytes((eu_x,)) / probe['ms'] / 1e9:.3f} "
          f"TB/s per call, {reps} calls a run (published peak 3.35 TB/s)", flush=True)
    return line


def masked_phase(torch, records, cases, reps):
    """masked_w_update / masked_h_update against their plain versions:
    EU and KL, lam 0 and 0.2, a 1-byte binary mask and an f32 weight
    mask, each with a fully unobserved row and column, with their device
    time and rate; at the last shape both also on bf16 X (uint8 mask),
    where a second call of each must give the same bits (f32 and bf16 X)."""
    from tpunmf_torch.ops import masked_fused as mf
    from tpunmf_torch.ops import roofline

    for case, (label, x, observed, k) in enumerate(cases):
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(10)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        binary = observed.to(torch.uint8)
        binary[0, :] = 0
        binary[:, 0] = 0
        weights = binary * (0.5 + torch.rand((m, n), generator=g, device="cuda"))
        for mask_name, mask in (("uint8", binary), ("f32 weights", weights)):
            for dist in ("eu", "kl"):
                for lam in (0.0, 0.2):
                    kw = dict(distance_type=dist, lam=lam)
                    what = f"{dist} lam={lam} {mask_name}"
                    # S = W H and two products against a factor: 6 m n k
                    work = dict(inputs=(x, mask, w, h), flops=roofline.masked_flops(m, n, k))
                    check_kernel(torch, records, "masked_w_update", label, what,
                                 lambda: mf.masked_w_update(x, mask, w, h, **kw),
                                 lambda: mf.masked_w_update_ref(x, mask, w, h, **kw),
                                 UPDATE_RTOL, reps, profiled=True, **work)
                    check_kernel(torch, records, "masked_h_update", label, what,
                                 lambda: mf.masked_h_update(x, mask, w, h, **kw),
                                 lambda: mf.masked_h_update_ref(x, mask, w, h, **kw),
                                 UPDATE_RTOL, reps, profiled=True, **work)
        if case == len(cases) - 1:
            xb = x.bfloat16()
            for dist in ("eu", "kl"):
                kw = dict(distance_type=dist, lam=0.2)
                for name in ("masked_w_update", "masked_h_update"):
                    kern, ref = getattr(mf, name), getattr(mf, name + "_ref")
                    check_kernel(torch, records, name, label[:-3] + "bf16",
                                 f"{dist} lam=0.2 uint8",
                                 lambda: kern(xb, binary, w, h, **kw),
                                 lambda: ref(xb, binary, w, h, **kw),
                                 UPDATE_RTOL, reps, inputs=(xb, binary, w, h),
                                 flops=roofline.masked_flops(m, n, k))
                    for xx in (x, xb):
                        first = kern(xx, binary, w, h, **kw)
                        require(torch.equal(first, kern(xx, binary, w, h, **kw)),
                                f"{name} {label} {dist} {xx.dtype}: two calls differ")
            print(f"  masked_w_update {label}: {mf.w_block_rows(m, k)}-row blocks, H read at "
                  f"row stride {mf.h_stride(n)}; masked_h_update: {mf.row_splits(m, n, k)} "
                  f"row splits; both the same bits on a second call (eu, kl; f32 and bf16 X)",
                  flush=True)
            del xb, first
        del w, h, binary, weights


PASS_CASE = {"kl_ratio": "ratio", "kl_ratio_and_obj": "ratio, objective",
             "eu_residual_obj": "eu", "kl_obj": "kl"}


def pass_phase(torch, records, cases, reps):
    """The ratio and objective passes of csrc/objective.cu (one tensor-core
    body) against their plain versions: kl_ratio elementwise within
    UPDATE_RTOL (W H is a sum of positive terms, so the only error is f32
    summation order), the objectives (and kl_ratio_and_obj's ratio) within
    OBJECTIVE_RTOL, with their device time and rate at the paths' shapes;
    and wherever a KL pass runs, kl_ratio's ratio and kl_obj's objective
    must be kl_ratio_and_obj's bit for bit."""
    from tpunmf_torch.ops import fused

    for name, label, x, k in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(12)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        kern, ref = getattr(fused, name), getattr(fused, name + "_ref")
        check_kernel(torch, records, name, label, PASS_CASE[name],
                     lambda: kern(x, w, h), lambda: ref(x, w, h),
                     UPDATE_RTOL if name == "kl_ratio" else OBJECTIVE_RTOL, reps,
                     inputs=(x, w, h), flops=mur_flops(name, x, k),
                     profiled=not label.startswith("ragged"))
        if name in ("kl_ratio_and_obj", "kl_obj"):  # one body: the same bits
            ratio, obj = fused.kl_ratio_and_obj(x, w, h)
            diff = bit_err(fused.kl_ratio(x, w, h), ratio)
            require(diff == 0.0, f"kl_ratio and kl_ratio_and_obj {label}: ratios differ "
                                 f"by {diff:.3e}")
            diff = bit_err(fused.kl_obj(x, w, h), obj)
            require(diff == 0.0, f"kl_obj and kl_ratio_and_obj {label}: objectives differ "
                                 f"by {diff:.3e}")
            del ratio, obj
        del w, h


def serving_kernel_phase(torch, records, reps):
    """blockmax_relayout (bit for bit) and score_blockmax_relayout
    (SCORE_TOL) against their plain versions at the serving shapes, and
    torch.topk on the full (64, 2^20) scores beside the block-max route."""
    from tpunmf_torch.ops import topk_select as ts
    from tpunmf_torch.serve import topk

    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    for label, b, n, dtype in ((f"serve ({SERVE_BATCH}, {1 << 20}) f32", SERVE_BATCH,
                                1 << 20, torch.float32),
                               (f"serve ({SERVE_BATCH}, {1 << 20}) bf16", SERVE_BATCH,
                                1 << 20, torch.bfloat16),
                               ("ragged (3, 40000) f32", 3, 40000, torch.float32),
                               (f"two row tiles (96, {1 << 20}) f32", 96, 1 << 20,
                                torch.float32)):
        s = torch.randn((b, n), generator=g, device="cuda").to(dtype)
        # where the blocks tile n exactly (n = 2^20), the kernel returns s3
        # as a view of the scores (no bytes written: the bound is the read of
        # S plus the maxima) and one torch.amax of that view computes the
        # same maxima: the library call
        library = ((lambda: torch.amax(s.view(b, n // 128, 128), dim=2))
                   if n % (128 * 128) == 0 else None)
        check_kernel(torch, records, "blockmax_relayout", label, "bit for bit",
                     lambda: ts.blockmax_relayout(s), lambda: ts.blockmax_relayout_ref(s),
                     0.0, reps, err=bit_err, inputs=(s,), flops=(float(b * n), 0.0, 0.0),
                     library=library)
        if dtype == torch.float32 and b == SERVE_BATCH:
            scores = s
        del s
    for label, b, r, n, hdtype in (
            (f"serve ({SERVE_BATCH}, 128)x(128, {1 << 20}) f32", SERVE_BATCH, 128,
             1 << 20, torch.float32),
            (f"serve ({SERVE_BATCH}, 128)x(128, {1 << 20}) bf16 H", SERVE_BATCH, 128,
             1 << 20, torch.bfloat16),
            (f"serve ({SERVE_BATCH}, 512)x(512, {1 << 19}) f32", SERVE_BATCH, 512,
             1 << 19, torch.float32),
            ("ragged (96, 128)x(128, 40000) f32", 96, 128, 40000, torch.float32)):
        w = torch.rand((b, r), generator=g, device="cuda").to(hdtype)
        h = torch.rand((r, n), generator=g, device="cuda").to(hdtype)
        product = 2.0 * b * r * n  # and one comparison a score
        flops = ((b * n, product, 0.0) if hdtype == torch.bfloat16 else (b * n, 0.0, product))
        check_kernel(torch, records, "score_blockmax_relayout", label, "f32 accumulate",
                     lambda: ts.score_blockmax_relayout(w, h),
                     lambda: ts.score_blockmax_relayout_ref(w, h), SCORE_TOL, reps,
                     err=close_err, inputs=(w, h), flops=flops)
        del w, h

    # torch.topk of the whole score matrix against the block-max route
    # (blockmax_relayout + the gathered sort) on the same scores
    got = topk._exact_topk(scores, SERVE_K)
    want = torch.topk(scores, SERVE_K)
    require(torch.equal(got[0], want.values), "torch.topk and the block-max route "
                                              "disagree on the top-k values")
    route_ms, topk_ms = time_pair(torch, lambda: torch.topk(scores, SERVE_K),
                                  lambda: topk._exact_topk(scores, SERVE_K), reps)
    line = {"scores": [SERVE_BATCH, 1 << 20], "k": SERVE_K, "torch_topk_ms": topk_ms,
            "blockmax_route_ms": route_ms}
    print(f"  torch.topk of ({SERVE_BATCH}, {1 << 20}) f32 at k={SERVE_K}: "
          f"{topk_ms:.4f} ms; block-max route on the same scores {route_ms:.4f} ms "
          f"(same values)", flush=True)
    return line


def reset_counters(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def counts(counters):
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def run_path(torch, counters, label, needed, body):
    """Drive one path: every count set to 0 just before it, read just
    after; each kernel the path runs must have launched."""
    t0 = time.perf_counter()
    reset_counters(counters)
    out = body()
    launched = counts(counters)
    print(f"  {label}: launches {launched} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for name in needed:
        require(launched[name] > 0, f"{label}: {name} was not launched")
    return out, launched


def run_slice(torch, tt, wrappers, label, x, k, distance, data_dtype, card,
              iters, method="mur", needed=None, banned=(), exact=None, **extra):
    """One NMF run of `iters` iterations on the fused route, and the plain
    route over the same run for comparison; returns the rates, the routes'
    agreement and the fused route's trace.  The fused run must launch every
    kernel of ``needed``, none of ``banned`` (the other route's), and each
    kernel of ``exact`` exactly that many times."""
    kw = dict(method=method, min_iter=iters, max_iter=iters, **extra)
    if method in ("mur", "admm"):
        kw["distance_type"] = distance
    if data_dtype is not None:
        kw["data_dtype"] = data_dtype
    # warm-up: first-call costs (allocator, cuBLAS handles) stay out of timing
    tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})
    tt.NMF(x, k).factorize(use_pallas=False, **{**kw, "min_iter": 2, "max_iter": 2})

    before = counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused = tt.NMF(x, k).factorize(**kw)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    launched = {n: c - before[n] for n, c in counts(wrappers).items()}

    t0 = time.perf_counter()
    plain = tt.NMF(x, k).factorize(use_pallas=False, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    require(counts(wrappers) == {n: before[n] + launched[n] for n in before},
            f"{label}: the plain route launched a kernel")

    hist = np.asarray(fused.obj_history, dtype=np.float64)
    plain_hist = np.asarray(plain.obj_history, dtype=np.float64)
    dname = "bfloat16" if data_dtype == torch.bfloat16 else "float32"
    rtol = ROUTE_RTOL[dname]
    route_err = float(np.max(np.abs(hist[:ROUTE_ITERS + 1]
                                    - plain_hist[:ROUTE_ITERS + 1])
                             / np.abs(plain_hist[:ROUTE_ITERS + 1])))
    print(f"  {label}: i={fused.i} obj[0]={hist[0]:.6e} obj[{iters}]={hist[-1]:.6e} "
          f"plain obj[{iters}]={plain_hist[-1]:.6e}", flush=True)
    print(f"  {label}: fused {iters / fused_s:.2f} it/s, plain {iters / plain_s:.2f} it/s "
          f"(wall clock over factorize(), init included; {card})", flush=True)
    print(f"  {label}: first {ROUTE_ITERS} iterations fused vs plain max rel "
          f"{route_err:.3e} (tol {rtol:.0e}); launches {launched}", flush=True)

    require(fused.i == iters - 1 and len(hist) == iters + 1,
            f"{label}: ran {fused.i + 1} iterations, expected {iters}")
    require(np.all(np.isfinite(hist)), f"{label}: non-finite objective")
    require(np.all(np.isfinite(fused.w)) and np.all(np.isfinite(fused.h)),
            f"{label}: non-finite factors")
    require(fused.w.shape == (x.shape[0], k) and fused.h.shape == (k, x.shape[1]),
            f"{label}: factor shapes {fused.w.shape} {fused.h.shape}")
    require(route_err <= rtol, f"{label}: fused and plain routes disagree "
                               f"({route_err:.3e} > {rtol:.0e})")
    if distance == "eu" and method != "admm":  # ADMM's trace is not monotone
        rises = np.diff(hist) / hist[:-1]
        require(np.all(rises <= EU_MONOTONE_RTOL),
                f"{label}: EU objective rose by {rises.max():.3e}")
    if needed is None:
        needed = ("mur_w_update", "mur_h_update",
                  "kl_obj" if distance == "kl" else "eu_residual_obj")
    for name in needed:
        require(launched[name] > 0, f"{label}: {name} was not launched")
    for name in banned:
        require(launched[name] == 0, f"{label}: {name} was launched off its route")
    for name, count in (exact or {}).items():
        require(launched[name] == count,
                f"{label}: {name} launched {launched[name]} times, not {count}")
    return {"fused_it_s": iters / fused_s, "plain_it_s": iters / plain_s,
            "route_err": route_err, "trace": hist.tolist()}


def lagged_run(torch, tt, wrappers, label, x, k, exact_trace, iters, card, needed):
    """MUR KL with objective='lagged' on the kernel route: its trace is the
    exact route's shifted by one iteration, and it launches ``needed``."""
    kw = dict(method="mur", distance_type="kl", min_iter=iters, max_iter=iters,
              objective="lagged")
    tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})
    before = counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tt.NMF(x, k).factorize(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for name in needed:
        require(counts(wrappers)[name] > before[name], f"{label}: {name} was not launched")
    lagged = np.asarray(res.obj_history, dtype=np.float64)
    exact = np.asarray(exact_trace)
    require(res.i == iters - 1 and len(lagged) == iters + 1,
            f"{label}: ran {res.i + 1} iterations, expected {iters}")
    require(np.all(np.isfinite(lagged)), f"{label}: non-finite objective")
    require(np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h)),
            f"{label}: non-finite factors")
    shift_err = float(np.max(np.abs(lagged[1:] - exact[:-1]) / np.abs(exact[:-1])))
    first_err = abs(lagged[0] - exact[0]) / abs(exact[0])
    print(f"  {label}: i={res.i} lagged[1:] vs exact[:-1] max rel {shift_err:.3e}, "
          f"lagged[0] vs exact[0] {first_err:.3e} (tol {LAGGED_RTOL:.0e}); "
          f"{iters / secs:.2f} it/s (wall clock over factorize(); {card})", flush=True)
    require(shift_err <= LAGGED_RTOL and first_err <= LAGGED_RTOL,
            f"{label}: the lagged trace is not the exact trace shifted by one")
    return {"fused_it_s": iters / secs, "shift_err": shift_err}


def switched_run(torch, tt, wrappers, label, x, k, ref_trace, rtol, exact, card, iters,
                 **kw):
    """One NMF run of `iters` iterations with a route switch flipped: it
    launches each kernel of ``exact`` exactly that many times, its trace is
    finite and non-increasing (EU), and its first iterations agree with
    ``ref_trace``, the default route's run from the same init, within rtol."""
    kw = dict(min_iter=iters, max_iter=iters, **kw)
    tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})
    before = counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tt.NMF(x, k).factorize(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {n: c - before[n] for n, c in counts(wrappers).items()}
    hist = np.asarray(res.obj_history, dtype=np.float64)
    ref = np.asarray(ref_trace)
    first = slice(0, ROUTE_ITERS + 1)
    err = float(np.max(np.abs(hist[first] - ref[first]) / np.abs(ref[first])))
    whole = float(np.max(np.abs(hist - ref) / np.abs(ref)))
    print(f"  {label}: i={res.i} obj[{iters}]={hist[-1]:.6e}; {iters / secs:.2f} it/s "
          f"(wall clock over factorize(), init included; {card}); first {ROUTE_ITERS} "
          f"iterations against the default route max rel {err:.3e} (tol {rtol:.0e}), "
          f"all {iters} {whole:.3e}; launches {launched}", flush=True)
    require(res.i == iters - 1 and len(hist) == iters + 1,
            f"{label}: ran {res.i + 1} iterations, expected {iters}")
    require(np.all(np.isfinite(hist)), f"{label}: non-finite objective")
    require(np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h)),
            f"{label}: non-finite factors")
    require(res.w.shape == (x.shape[0], k) and res.h.shape == (k, x.shape[1]),
            f"{label}: factor shapes {res.w.shape} {res.h.shape}")
    require(err <= rtol, f"{label}: the switched and default routes disagree "
                         f"({err:.3e} > {rtol:.0e})")
    rises = np.diff(hist) / hist[:-1]
    require(np.all(rises <= EU_MONOTONE_RTOL), f"{label}: EU objective rose by {rises.max():.3e}")
    for name, count in exact.items():
        require(launched[name] == count,
                f"{label}: {name} launched {launched[name]} times, not {count}")
    return {"fused_it_s": iters / secs, "route_err": err, "trace_err": whole}


def device_ms_by_kernel(prof, per):
    """Device ms by kernel in a profile, over ``per`` iterations or
    requests; cuBLAS's products under one name."""
    import re

    from torch.autograd import DeviceType

    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            name = re.sub(r"^(void )?([\w:]+::)?(\(anonymous namespace\)::)?", "", e.key)
            name = re.split(r"[<(]", name)[0]
            if "gemm" in e.key.lower() or "splitK" in e.key:
                name = "cuBLAS GEMM"
            kernels[name] = kernels.get(name, 0.0) + us / 1e3 / per
    return kernels


def profile_run(torch, tt, label, x, k, distance, iters=20, plain=False, method="mur",
                **extra):
    """Device time by kernel over one factorize() of `iters` iterations
    (torch.profiler; the kernels run on one stream, so their sum is their
    union), it/s in that window, and the device's idle share of its host
    wall time (an upper bound: the profiler's own overhead is inside)."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(method=method, min_iter=iters, max_iter=iters, **extra)
    if method == "mur":
        kw["distance_type"] = distance
    if plain:
        kw["use_pallas"] = False
    tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tt.NMF(x, k).factorize(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_ms_by_kernel(prof, iters)
    device = sum(kernels.values())
    out = {"device_ms_per_it": device, "wall_ms_per_it": 1e3 * wall / iters,
           "it_s": iters / wall, "idle_share": 1.0 - device * iters / (1e3 * wall),
           "kernels_ms_per_it": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])}
    print(f"  profile {label}: {out['device_ms_per_it']:.3f} ms/it on the device, "
          f"{out['it_s']:.1f} it/s, idle share {out['idle_share']:.3f}; "
          + ", ".join(f"{n} {v:.3f}" for n, v in out["kernels_ms_per_it"].items()), flush=True)
    return out


def movielens_on_card(torch, n_users, n_items, density, seed, n_factors=8):
    """movielens_like's recipe (tpunmf_torch/data/synthetic.py) with the
    m x n work on the card: the planted gamma factors from numpy, the
    scores in f32 and the observed support from a seeded CUDA generator
    (numpy at f64 would need about 20 GB of host memory at MovieLens-10M).
    Returns X (f32, ratings 1..5 on the support, 0 elsewhere) and the
    observed mask."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.gamma(2.0, 1.0, (n_users, n_factors))).float().cuda()
    v = torch.from_numpy(rng.gamma(2.0, 1.0, (n_factors, n_items))).float().cuda()
    x = u @ v
    lo, hi = x.min(), x.max()
    x.sub_(lo).mul_(4.0 / (hi - lo + 1e-9)).add_(1.0).round_()
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    observed = torch.rand((n_users, n_items), generator=g, device="cuda") < density
    x.mul_(observed)
    return x, observed


@contextlib.contextmanager
def two_pass_route():
    """MUR with tpunmf's single-pass rule turned off: every shape takes the
    2-pass pair (for comparing the two routes at one shape)."""
    mur = sys.modules["tpunmf_torch.solvers.mur"]
    saved = mur.iter_eu_tileable, mur.iter_kl_tileable
    mur.iter_eu_tileable = mur.iter_kl_tileable = lambda x, k: None
    try:
        yield
    finally:
        mur.iter_eu_tileable, mur.iter_kl_tileable = saved


@contextlib.contextmanager
def switched(**values):
    """The port's route switches (tpunmf_torch/solvers/cuda_defaults.py) set
    to ``values``, e.g. hals_single_pass=True, and restored after."""
    from tpunmf_torch.solvers import cuda_defaults

    saved = {name: getattr(cuda_defaults, name) for name in values}
    for name, value in values.items():
        setattr(cuda_defaults, name, lambda device, v=value: v)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(cuda_defaults, name, fn)


@contextlib.contextmanager
def plain_serving():
    """The serving code with the kernels' plain versions in their place:
    the plain route that the kernel route is compared with."""
    from tpunmf_torch.ops import topk_select as ts
    from tpunmf_torch.serve import topk

    saved = topk.blockmax_relayout, topk.score_blockmax_relayout
    topk.blockmax_relayout = ts.blockmax_relayout_ref
    topk.score_blockmax_relayout = ts.score_blockmax_relayout_ref
    try:
        yield
    finally:
        topk.blockmax_relayout, topk.score_blockmax_relayout = saved


def serving_data(torch, r, n, seed, exclusion=False):
    """W for SERVE_BATCHES batches of SERVE_BATCH users and H, U[0,1) from a
    seeded CUDA generator (bench.py's serving cells draw the same
    distribution); with ``exclusion`` 1% of the items of every user."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    users = torch.rand((SERVE_BATCHES * SERVE_BATCH, r), generator=g, device="cuda")
    h = torch.rand((r, n), generator=g, device="cuda")
    excl = None
    if exclusion:
        excl = torch.rand((SERVE_BATCHES * SERVE_BATCH, n), generator=g,
                          device="cuda") < 0.01
    return users, h, excl


def serve_batches(torch, request):
    """request(i) for every batch after two warm-up calls: the answers and
    each batch's latency in ms (CUDA events around the request; the
    request's own host read of its acceptance check is inside)."""
    request(0)
    request(1)
    answers, ms = [], []
    for i in range(SERVE_BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        answers.append(request(i))
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return answers, ms


def serving_profile(torch, request, requests=10):
    """Device and wall ms per request over ``requests`` requests
    (torch.profiler's kernel time, and the host clock around them with a
    synchronize at the end: an upper bound, the profiler's overhead is
    inside), the device's idle share of that wall time, and the three
    kernels that take the most device time, ms per request."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(requests):
            request(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_ms_by_kernel(prof, requests)
    device_ms, wall_ms = sum(kernels.values()), 1e3 * wall / requests
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:3])
    return device_ms, wall_ms, 1.0 - device_ms / wall_ms, top


def serving_mode(torch, label, request):
    """One serving mode on the kernel route and on the plain route, CUDA
    events around each request."""
    kernel_answers, kernel_ms = serve_batches(torch, request)
    with plain_serving():
        plain_answers, plain_ms = serve_batches(torch, request)
    worst = 0.0
    for (kv, _), (pv, _) in zip(kernel_answers, plain_answers):
        worst = max(worst, float(((kv.double() - pv.double()).abs()
                                  / pv.double().abs()).max()))
    same_idx = float(np.mean([float((ki == pi).float().mean()) for (_, ki), (_, pi)
                              in zip(kernel_answers, plain_answers)]))
    out = {"batch_ms": float(np.mean(kernel_ms)), "plain_batch_ms": float(np.mean(plain_ms)),
           "batch_ms_max": float(np.max(kernel_ms)),
           "qps": SERVE_BATCH * 1e3 / float(np.mean(kernel_ms)),
           "plain_qps": SERVE_BATCH * 1e3 / float(np.mean(plain_ms)),
           "value_err": worst, "same_indices": same_idx}
    print(f"  {label}: kernel route {out['batch_ms']:.4f} ms/batch "
          f"({out['qps']:.0f} QPS), plain route {out['plain_batch_ms']:.4f} ms/batch "
          f"({out['plain_qps']:.0f} QPS); values kernel vs plain max rel {worst:.3e} "
          f"(tol {SERVE_VALUE_RTOL:.0e}), same indices {same_idx:.4f}", flush=True)
    require(worst <= SERVE_VALUE_RTOL, f"{label}: kernel and plain routes disagree")
    for v, i in kernel_answers + plain_answers:
        require(v.shape == (SERVE_BATCH, SERVE_K) and i.dtype == torch.int64,
                f"{label}: answer of shape {tuple(v.shape)}, {i.dtype}")
        require(bool(torch.isfinite(v).all()), f"{label}: non-finite top-k values")
    return out, kernel_answers, plain_answers


def check_own_scores(torch, label, answers, scores_of, batches=2, candidates=None):
    """Each of the first ``batches`` answers equals a stable sort of the
    scores its route ranked: all n of them, or the (b, c) rescored
    candidates ``candidates(i)`` gives with ``scores_of(i)`` (ties then go
    to the earlier candidate, as tpunmf's rerank orders them)."""
    from tpunmf_torch.serve import topk

    for i in range(batches):
        v, idx = topk._topk(scores_of(i), SERVE_K)
        if candidates is not None:
            idx = torch.gather(candidates(i), 1, idx)
        bad = int((v != answers[i][0]).sum() + (idx != answers[i][1]).sum())
        require(bad == 0, f"{label}: batch {i} is not the top-k of its own scores "
                          f"({bad} of {2 * v.numel()} entries differ)")


def serving_path(torch, runs):
    """The serving cells; returns what check_serving needs afterwards (the
    checks launch kernels, which must not count toward the path)."""
    from tpunmf_torch.serve import topk

    kept = {}
    users, h, excl = serving_data(torch, 128, 1 << 20, seed=21, exclusion=True)
    hq = h.to(torch.bfloat16)  # the stored low-precision copy
    batch = lambda i: users[i * SERVE_BATCH:(i + 1) * SERVE_BATCH]
    modes = {
        "serve exact r128": lambda i: topk.topk_scores_dense(batch(i), h, SERVE_K),
        "serve bf16 r128": lambda i: topk.topk_retrieval(
            None, batch(i), h, SERVE_K, first_stage_dtype="bf16", h_quantized=hq,
            oversample=2),
        "serve exclude r128": lambda i: topk.topk_retrieval(
            None, batch(i), h, SERVE_K,
            exclude=excl[i * SERVE_BATCH:(i + 1) * SERVE_BATCH]),
    }
    users512, h512, _ = serving_data(torch, 512, 1 << 19, seed=22)
    batch512 = lambda i: users512[i * SERVE_BATCH:(i + 1) * SERVE_BATCH]
    modes["serve exact r512"] = lambda i: topk.topk_scores_dense(batch512(i), h512, SERVE_K)
    for label, request in modes.items():
        runs[label], kernel, plain = serving_mode(torch, label, request)
        kept[label] = (kernel, plain)
    kept["r128"] = (batch, h, hq, excl)
    kept["r512"] = (batch512, h512)
    kept["requests"] = modes
    return kept


def profile_serving(torch, runs, requests):
    """Each serving mode's device and wall ms per request on both routes
    (serving_profile), after the serving path's counts were read: the
    profiled requests are not the path's."""
    for label, request in requests.items():
        kernel = serving_profile(torch, request)
        with plain_serving():
            plain = serving_profile(torch, request)
        runs[label].update(device_ms=kernel[0], wall_ms=kernel[1], idle_share=kernel[2],
                           kernels_ms=kernel[3], plain_device_ms=plain[0],
                           plain_wall_ms=plain[1], plain_idle_share=plain[2],
                           plain_kernels_ms=plain[3])
        for route, p in (("kernel", kernel), ("plain", plain)):
            print(f"  {label}: profiled {route} route, ms per request device / wall "
                  f"{p[0]:.4f} / {p[1]:.4f} (idle {p[2]:.3f}); "
                  + ", ".join(f"{n} {v:.4f}" for n, v in p[3].items()), flush=True)


def check_serving(torch, runs, kept):
    """Every serving answer against its own scores (the kernel route's
    rebuilt from the kernel's s3), and the quantized route's recall@100
    against the exact route."""
    from tpunmf_torch.ops import topk_select as ts
    from tpunmf_torch.serve import topk

    batch, h, hq, excl = kept["r128"]
    batch512, h512 = kept["r512"]

    def from_s3(w, hh):
        return ts.score_blockmax_relayout(w, hh)[1].reshape(w.shape[0], -1)[:, :hh.shape[1]]

    for label, bt, hh in (("serve exact r128", batch, h), ("serve exact r512", batch512, h512)):
        kernel, plain = kept[label]
        check_own_scores(torch, label + " kernel", kernel, lambda i: from_s3(bt(i), hh))
        check_own_scores(torch, label + " plain", plain, lambda i: topk._score(bt(i), hh))
    kernel, plain = kept["serve exclude r128"]
    masked = lambda i: torch.where(excl[i * SERVE_BATCH:(i + 1) * SERVE_BATCH], -torch.inf,
                                   topk._score(batch(i), h))
    check_own_scores(torch, "serve exclude r128 kernel", kernel, masked)
    check_own_scores(torch, "serve exclude r128 plain", plain, masked)
    for i in range(SERVE_BATCHES):
        taken = torch.gather(excl[i * SERVE_BATCH:(i + 1) * SERVE_BATCH], 1, kernel[i][1])
        require(not bool(taken.any()), "serve exclude r128: an excluded item was served")

    # quantized: the candidates are the top 2k of the first stage's own
    # scores, reranked by the exact rescore of those candidates
    kernel, plain = kept["serve bf16 r128"]
    for route, answers, stage in (("kernel", kernel, lambda w: from_s3(w, hq)),
                                  ("plain", plain, lambda w: topk._score(w, hq))):
        def cands(i, stage=stage):
            return topk._topk(stage(batch(i).to(torch.bfloat16)), 2 * SERVE_K)[1]

        def rescored(i):
            return torch.bmm(h.T[cands(i)], batch(i)[:, :, None])[:, :, 0]
        check_own_scores(torch, f"serve bf16 r128 {route}", answers, rescored,
                         candidates=cands)
    exact_kernel = kept["serve exact r128"][0]
    recall = float(np.mean([topk.recall_at_k(q[1], e[1]) for q, e in zip(kernel, exact_kernel)]))
    runs["serve bf16 r128"]["recall_at_100"] = recall
    print(f"  serve bf16 r128: recall@{SERVE_K} against the exact route {recall:.4f}; "
          f"every answer is the top-k of its own scores", flush=True)


def config3_on_card(torch):
    """BASELINE config[3]'s matrix, made on the host with the seed's draws
    and densified to float32 on the card."""
    from tpunmf_torch.data import densify, sparse_csr

    csr = sparse_csr(CONFIG3["m"], CONFIG3["n"], density=CONFIG3["density"],
                     k=CONFIG3["k"], seed=CONFIG3["seed"])
    x = torch.from_numpy(densify(csr)).cuda()
    return x, csr.nnz


def roundtrip_phase(tt, x, k):
    model = tt.NMF(x, k)
    model.factorize(method="mur", distance_type="eu", min_iter=3, max_iter=3)
    with tempfile.TemporaryDirectory() as d:
        path = model.save_factorization(save_dir=d)
        loaded = tt.NMF.load_factorization(path)
    require(np.array_equal(loaded.w, model.w) and np.array_equal(loaded.h, model.h),
            "save/load: factors differ")
    require(loaded.results.i == model.results.i, "save/load: i differs")
    require(np.array_equal(np.asarray(loaded.results.obj_history),
                           np.asarray(model.results.obj_history)),
            "save/load: obj_history differs")
    require(loaded.default_save_name() == model.default_save_name(),
            "save/load: save name differs")
    print(f"  save/load round trip ok: {os.path.basename(path)}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tpunmf_torch")):
        print("chip_smoke: tpunmf_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import tpunmf_torch as tt
    from tpunmf_torch.data import lowrank_dense, movielens_like, tfidf_like
    from tpunmf_torch.init import nndsvd
    from tpunmf_torch.ops import (_build, fused, hals_sweep, masked_fused, mur_fused,
                                  mur_variants, read_probe, topk_select)
    from tpunmf_torch.sweeps import sweep_int8, sweep_iter2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"mur_w_update": (mur_fused.mur_w_update, "launches"),
                "mur_h_update": (mur_fused.mur_h_update, "launches"),
                "eu_residual_obj": (fused.eu_residual_obj, "launches"),
                "kl_obj": (fused.kl_obj, "launches"),
                "mur_w_update_lagged": (mur_fused.mur_w_update, "lagged_launches"),
                "gs_sweep": (hals_sweep.gs_sweep, "launches"),
                "masked_w_update": (masked_fused.masked_w_update, "launches"),
                "masked_h_update": (masked_fused.masked_h_update, "launches"),
                "kl_ratio_and_obj": (fused.kl_ratio_and_obj, "launches"),
                "blockmax_relayout": (topk_select.blockmax_relayout, "launches"),
                "score_blockmax_relayout": (topk_select.score_blockmax_relayout,
                                            "launches"),
                "mur_iteration_eu": (mur_fused.mur_iteration_eu, "launches"),
                "mur_iteration_kl": (mur_fused.mur_iteration_kl, "launches"),
                "kl_ratio": (fused.kl_ratio, "launches"),
                "mur_iteration_eu_dma": (mur_fused.mur_iteration_eu_dma, "launches"),
                "hals_iteration_eu": (hals_sweep.hals_iteration_eu, "launches"),
                "v1_iter": (mur_variants.v1_iter, "launches"),
                "v2_iter": (mur_variants.v2_iter, "launches"),
                "iter_eu_int8": (mur_variants.iter_eu_int8, "launches"),
                "read_probe": (read_probe.read_probe, "launches")}

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    print(f"phase 1: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()  # builds from tpunmf_torch/ops/csrc on first use
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    eu_np = lowrank_dense(8192, 8192, 128, seed=0)
    eu_x = torch.from_numpy(eu_np).cuda()
    kl_x = torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()
    eu_k, kl_k = 128, 50
    wide_x = torch.from_numpy(lowrank_dense(EU_WIDE["m"], EU_WIDE["n"], EU_WIDE["k"],
                                            seed=EU_WIDE["seed"])).cuda()
    kl2_x = torch.from_numpy(tfidf_like(KL_SINGLE["m"], KL_SINGLE["n"],
                                        n_topics=KL_SINGLE["k"], seed=KL_SINGLE["seed"])).cuda()
    kl2_label = f"KL {tuple(kl2_x.shape)} k{KL_SINGLE['k']} f32"
    high_kl_label = f"high-rank KL {tuple(kl2_x.shape)} k{HIGH_RANK} f32"
    high_eu_label = f"high-rank EU {tuple(eu_x.shape)} k{HIGH_RANK} f32"
    ragged_np = tfidf_like(1000, 777, n_topics=37, seed=2) + 0.05
    ragged_np[::7, ::5] = 0.0  # exact zeros for the KL masking
    ragged = torch.from_numpy(ragged_np).cuda()
    print(f"  data made in {time.perf_counter() - t0:.1f} s: EU {tuple(eu_x.shape)} and "
          f"{tuple(wide_x.shape)}, KL {tuple(kl_x.shape)} "
          f"({float((kl_x == 0).float().mean()):.4f} zeros) and {tuple(kl2_x.shape)} "
          f"({float((kl2_x == 0).float().mean()):.4f} zeros)", flush=True)
    t0 = time.perf_counter()
    # BASELINE config[2]'s MovieLens-1M stand-in (benchmarks/run_configs.py:151-155)
    ml1_x = torch.from_numpy(movielens_like(6040, 3706, density=0.2, seed=2)).cuda()
    ml10_x, ml10_obs = movielens_on_card(torch, *ML10M, seed=3)
    torch.cuda.synchronize()
    print(f"  MovieLens-shaped data made in {time.perf_counter() - t0:.1f} s: "
          f"{tuple(ml1_x.shape)} {float((ml1_x > 0).float().mean()):.4f} observed; "
          f"{tuple(ml10_x.shape)} {int(ml10_obs.sum())} observed", flush=True)
    t0 = time.perf_counter()
    adm_x, adm_nnz = config3_on_card(torch)
    adm_label = f"config[3] {tuple(adm_x.shape)} k{CONFIG3['k']} f32"
    print(f"  BASELINE config[3] made in {time.perf_counter() - t0:.1f} s: "
          f"{tuple(adm_x.shape)}, {adm_nnz} nonzeros", flush=True)

    t_phase = time.perf_counter()
    print("phase 2: kernels vs plain versions", flush=True)
    cases = [
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37, ("eu", "kl")),
        (f"ragged {tuple(ragged.shape)} k37 bf16", ragged.bfloat16(), 37, ("eu", "kl")),
        (f"EU {tuple(eu_x.shape)} k{eu_k} f32", eu_x, eu_k, ("eu",)),
        (f"EU {tuple(eu_x.shape)} k{eu_k} bf16", eu_x.bfloat16(), eu_k, ("eu",)),
        (f"KL {tuple(kl_x.shape)} k{kl_k} f32", kl_x, kl_k, ("kl",)),
    ]
    records = kernel_phase(torch, cases, reps=5)
    # mur_h_update's KL body where the pair runs KL 8192x4096 (the 2-pass
    # route and the lagged path)
    kernel_phase(torch, [(kl2_label, kl2_x, KL_SINGLE["k"], ("kl",),
                          ("mur_w_update", "mur_h_update"))], reps=5, records=records)
    lagged_phase(torch, records, ragged, 37, f"ragged {tuple(ragged.shape)} k37 f32", 5)
    lagged_phase(torch, records, kl_x, kl_k, f"KL {tuple(kl_x.shape)} k{kl_k} f32", 5)
    lagged_phase(torch, records, kl2_x, KL_SINGLE["k"], kl2_label, 3)
    route_line = iteration_phase(torch, records, [
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37, "eu", False),
        (f"ragged {tuple(ragged.shape)} k37 bf16", ragged.bfloat16(), 37, "eu", False),
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37, "kl", False),
        (f"ragged {tuple(ragged.shape)} k37 bf16", ragged.bfloat16(), 37, "kl", False),
        (f"EU {tuple(eu_x.shape)} k{eu_k} f32", eu_x, eu_k, "eu", True),
        (f"EU {tuple(eu_x.shape)} k{eu_k} bf16", eu_x.bfloat16(), eu_k, "eu", True),
        (kl2_label, kl2_x, KL_SINGLE["k"], "kl", True)], reps=5)
    sweep_phase(torch, records, [
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37),
        (f"EU {tuple(eu_x.shape)} k{eu_k} f32", eu_x, eu_k)], reps=3)
    masked_phase(torch, records, [
        (f"ML-1M {tuple(ml1_x.shape)} k64 f32", ml1_x, ml1_x > 0, 64),
        (f"ML-10M {tuple(ml10_x.shape)} k64 f32", ml10_x, ml10_obs, 64)], reps=3)
    bits = masked_w_bits(torch, masked_fused)
    print(f"  masked_w_update: sha256 of its outputs on the fixed inputs {bits[:16]}, "
          f"{'as' if bits == MASKED_W_BITS else 'NOT as'} before MUR's KL W pass shared "
          f"its kernel", flush=True)
    require(bits == MASKED_W_BITS, "masked_w_update: its bits moved")
    rag = f"ragged {tuple(ragged.shape)}"
    pass_phase(torch, records, [
        ("kl_ratio_and_obj", f"{rag} k37 f32", ragged, 37),
        ("kl_ratio_and_obj", f"KL {tuple(kl_x.shape)} k{kl_k} f32", kl_x, kl_k),
        ("kl_ratio_and_obj", adm_label, adm_x, CONFIG3["k"]),
        # the ratio pass of MUR's high-rank KL step, past the update
        # kernels' rank bound, and at the BASELINE row's shape
        ("kl_ratio", f"{rag} k37 f32", ragged, 37),
        ("kl_ratio", f"{rag} k37 bf16", ragged.bfloat16(), 37),
        ("kl_ratio", f"{rag} k1100 f32", ragged, 1100),
        ("kl_ratio", f"{rag} k1100 bf16", ragged.bfloat16(), 1100),
        ("kl_ratio", f"KL {tuple(kl_x.shape)} k{kl_k} f32", kl_x, kl_k),
        ("kl_ratio", high_kl_label, kl2_x, HIGH_RANK),
        # the high-rank step's objective passes at its shapes
        ("kl_ratio_and_obj", high_kl_label, kl2_x, HIGH_RANK),
        ("kl_obj", high_kl_label, kl2_x, HIGH_RANK),
        ("eu_residual_obj", high_eu_label, eu_x, HIGH_RANK),
        # the objectives at the paths' shapes: MUR EU's and HALS's, MUR KL's
        # at config[1] and KL 8192x4096, ADMM EU's at config[3]
        ("kl_obj", f"{rag} k37 f32", ragged, 37),
        ("eu_residual_obj", f"EU {tuple(eu_x.shape)} k{eu_k} f32", eu_x, eu_k),
        ("kl_obj", f"KL {tuple(kl_x.shape)} k{kl_k} f32", kl_x, kl_k),
        ("kl_obj", kl2_label, kl2_x, KL_SINGLE["k"]),
        ("eu_residual_obj", adm_label, adm_x, CONFIG3["k"])], reps=3)
    topk_line = serving_kernel_phase(torch, records, reps=5)
    dma_line = opt_in_phase(torch, records, eu_x, eu_k, ragged, reps=3)
    v1_line = variant_phase(torch, records, eu_x, eu_k, ragged, reps=3)
    print(f"  phase 2 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print("phase 3: the paths through NMF.factorize", flush=True)
    runs, launches = {}, {name: 0 for name in KERNELS}

    def mur_path():
        # tpunmf's route rule: the single pass at the EU headline and at
        # KL 8192x4096, the 2-pass pair at EU 8192x16384 and at config[1]
        for label, x, k, dist, dd, needed, banned in (
                ("EU bf16", eu_x, eu_k, "eu", torch.bfloat16, SINGLE_EU, PAIR),
                ("EU f32", eu_x, eu_k, "eu", None, SINGLE_EU, PAIR),
                ("EU f32 8192x16384", wide_x, EU_WIDE["k"], "eu", None,
                 PAIR + ("eu_residual_obj",), ("mur_iteration_eu",)),
                ("KL config[1]", kl_x, kl_k, "kl", None, PAIR + ("kl_obj",),
                 ("mur_iteration_kl",)),
                ("KL 8192x4096", kl2_x, KL_SINGLE["k"], "kl", None,
                 ("mur_iteration_kl", "kl_obj"), PAIR)):
            runs[label] = run_slice(torch, tt, counters, label, x, k, dist, dd,
                                    card, RUN_ITERS, needed=needed, banned=banned)
        # the same EU headline runs on the 2-pass pair, for the routes' it/s
        with two_pass_route():
            for label, dd in (("EU bf16 2-pass", torch.bfloat16), ("EU f32 2-pass", None)):
                runs[label] = run_slice(torch, tt, counters, label, eu_x, eu_k, "eu", dd,
                                        card, RUN_ITERS, needed=PAIR,
                                        banned=("mur_iteration_eu",))

    def high_rank_path():
        # above the update kernels' rank bound: tpunmf's jnp step with the
        # ratio and objective kernels, against the plain route
        for label, x, dist, exact in (
                (f"KL {tuple(kl2_x.shape)} k{HIGH_RANK}", kl2_x, "kl",
                 {"kl_ratio": RUN_ITERS, "kl_ratio_and_obj": RUN_ITERS + 1}),
                (f"EU {tuple(eu_x.shape)} k{HIGH_RANK}", eu_x, "eu",
                 {"eu_residual_obj": RUN_ITERS + 1})):
            runs[label] = run_slice(torch, tt, counters, label, x, HIGH_RANK, dist, None,
                                    card, RUN_ITERS, needed=tuple(exact), banned=UPDATES,
                                    exact=exact)

    def numpy_path():
        # numpy means the card, float64 as float32: each run must launch its
        # route's kernels (tpunmf's jnp.asarray makes float64 float32 too)
        runs_np = (
            ("MUR EU", eu_np.astype(np.float64), eu_k, dict(method="mur", distance_type="eu"),
             {"mur_iteration_eu": 5, "eu_residual_obj": 6}),
            ("MUR KL", eu_np.astype(np.float64), eu_k, dict(method="mur", distance_type="kl"),
             {"mur_w_update": 5, "mur_h_update": 5, "kl_obj": 6}),
            ("mask=", ragged_np.astype(np.float64), 37,
             dict(method="mur", distance_type="kl", mask=ragged_np > 0.1),
             {"masked_w_update": 5, "masked_h_update": 5}),
            ("HALS", ragged_np.astype(np.float64), 37, dict(method="hals"),
             {"gs_sweep": 10, "eu_residual_obj": 6}),
            ("ADMM", ragged_np.astype(np.float64), 37, dict(method="admm", distance_type="eu"),
             {"eu_residual_obj": 5}))
        for label, data, k, kw, exact in runs_np:
            t0 = time.perf_counter()
            before = counts(counters)
            res = tt.NMF(data, k).factorize(min_iter=5, max_iter=5, **kw)
            launched = {n: c - before[n] for n, c in counts(counters).items()}
            print(f"  NMF(numpy {data.shape} {data.dtype}) {label}: 5 iterations in "
                  f"{time.perf_counter() - t0:.1f} s, obj[5]={res.obj_history[-1]:.6e}, "
                  f"factors {res.w.dtype}; launches "
                  f"{ {n: c for n, c in launched.items() if c} }", flush=True)
            require(np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h))
                    and np.all(np.isfinite(res.obj_history)),
                    f"NMF(numpy float64) {label}: non-finite factors or trace")
            require(res.w.dtype == np.float32, f"NMF(numpy float64) {label}: factors "
                                               f"{res.w.dtype}, not float32")
            for name, count in exact.items():
                require(launched[name] == count, f"NMF(numpy float64) {label}: {name} "
                                                 f"launched {launched[name]} times, not {count}")

    def float64_tensor_path():
        # a CUDA float64 tensor asks for float64: the plain route, no kernel
        x = torch.from_numpy(ragged_np.astype(np.float64)).cuda()
        res = tt.NMF(x, 37).factorize(method="mur", distance_type="eu", min_iter=5,
                                      max_iter=5)
        require(res.w.dtype == np.float64 and np.all(np.isfinite(res.obj_history)),
                f"CUDA float64 tensor: factors {res.w.dtype} or a non-finite trace")
        print(f"  CUDA float64 tensor {tuple(x.shape)}: 5 iterations, factors "
              f"{res.w.dtype}, obj[5]={res.obj_history[-1]:.6e}", flush=True)

    def hals_path():
        t0 = time.perf_counter()
        # NNDSVD 'zero' once for both routes, nudged to 1e-16 as hals()
        # nudges the inits it makes (tpunmf/solvers/hals.py:221-225)
        w0, h0 = nndsvd(eu_x, eu_k, variant="zero")
        w0, h0 = w0.clamp(min=1e-16).contiguous(), h0.clamp(min=1e-16).contiguous()
        hals_init[:] = [w0, h0]
        torch.cuda.synchronize()
        print(f"  HALS: NNDSVD 'zero' init in {time.perf_counter() - t0:.1f} s", flush=True)
        runs["HALS EU f32"] = run_slice(
            torch, tt, counters, "HALS EU f32", eu_x, eu_k, "eu", None, card,
            RUN_ITERS, method="hals", needed=("gs_sweep", "eu_residual_obj"),
            inner_sweeps=2, w_init=w0, h_init=h0)

    def hals_single_path():
        # tpunmf's hals_single_pass, off by default, on: the HALS path's run
        # again, from its init, through hals_iteration_eu
        w0, h0 = hals_init
        with switched(hals_single_pass=True):
            runs["HALS EU f32 single pass"] = switched_run(
                torch, tt, counters, "HALS EU f32 single pass", eu_x, eu_k,
                runs["HALS EU f32"]["trace"], SWEEP_TOL,
                {"hals_iteration_eu": RUN_ITERS, "gs_sweep": RUN_ITERS,
                 "eu_residual_obj": RUN_ITERS + 1}, card, RUN_ITERS,
                method="hals", inner_sweeps=2, w_init=w0, h_init=h0)
            profiles["HALS EU f32 single pass"] = profile_run(
                torch, tt, "HALS EU f32 single pass", eu_x, eu_k, "eu", method="hals",
                inner_sweeps=2, w_init=w0, h_init=h0)
        profiles["HALS EU f32"] = profile_run(torch, tt, "HALS EU f32", eu_x, eu_k, "eu",
                                              method="hals", inner_sweeps=2, w_init=w0,
                                              h_init=h0)

    def mur_dma_path():
        # tpunmf's mur_single_pass_variant "dma": the MUR path's EU headline
        # runs again (the same random init) through mur_iteration_eu_dma
        with switched(mur_single_pass_variant="dma"):
            for label, dd in (("EU bf16", torch.bfloat16), ("EU f32", None)):
                dname = "bfloat16" if dd is not None else "float32"
                runs[label + " dma"] = switched_run(
                    torch, tt, counters, label + " dma", eu_x, eu_k, runs[label]["trace"],
                    ROUTE_RTOL[dname], {"mur_iteration_eu_dma": RUN_ITERS,
                                        "mur_iteration_eu": 0,
                                        "eu_residual_obj": RUN_ITERS + 1},
                    card, RUN_ITERS, method="mur", distance_type="eu", data_dtype=dd)
            profiles["EU f32 dma"] = profile_run(torch, tt, "EU f32 dma", eu_x, eu_k, "eu")

    def masked_path():
        for dist in ("eu", "kl"):
            label = f"masked {dist.upper()} ML-10M"
            runs[label] = run_slice(
                torch, tt, counters, label, ml10_x, 64, dist, None, card, RUN_ITERS,
                needed=("masked_w_update", "masked_h_update"), mask=ml10_obs)

    def lagged_path():
        runs["KL config[1] lagged"] = lagged_run(
            torch, tt, counters, "KL config[1] lagged", kl_x, kl_k,
            runs["KL config[1]"]["trace"], RUN_ITERS, card,
            needed=("mur_w_update_lagged", "mur_h_update"))
        runs["KL 8192x4096 lagged"] = lagged_run(
            torch, tt, counters, "KL 8192x4096 lagged", kl2_x, KL_SINGLE["k"],
            runs["KL 8192x4096"]["trace"], RUN_ITERS, card, needed=("mur_iteration_kl",))

    def admm_path():
        for label, dist, mode in (("ADMM EU fixed config[3]", "eu", "fixed"),
                                  ("ADMM EU adaptive config[3]", "eu", "adaptive"),
                                  ("ADMM KL config[3]", "kl", "fixed")):
            runs[label] = run_slice(
                torch, tt, counters, label, adm_x, CONFIG3["k"], dist, None, card,
                RUN_ITERS, method="admm",
                needed=("eu_residual_obj" if dist == "eu" else "kl_ratio_and_obj",),
                rho_mode=mode, **ADMM_KW)

    def sweep_path():
        # the sweep scripts' loops at their shape, 30 iterations each from
        # the scripts' init; warm-up runs happen before the counts are reset
        x, w0, h0 = sweep_data["iter2"]
        out = {}
        for label, make in (("v1 loop", sweep_iter2.make_v1), ("v2 loop", sweep_iter2.make_v2)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[label] = float(make(128)(x, w0, h0, SWEEP_ITERS))  # a host read
            secs = time.perf_counter() - t0
            runs[f"sweep {label} bf16"] = {"it_s": SWEEP_ITERS / secs, "value": out[label]}
            print(f"  sweep {label} {tuple(x.shape)} r128 bf16: {SWEEP_ITERS} iterations, "
                  f"{SWEEP_ITERS / secs:.2f} it/s (wall clock; {card}); sum(W[0]) + "
                  f"sum(H[:, 0]) = {out[label]:.6e}", flush=True)
        err = abs(out["v1 loop"] - out["v2 loop"]) / abs(out["v1 loop"])
        print(f"  sweep v1 loop vs v2 loop: rel {err:.3e} (tol {ROUTE_RTOL['bfloat16']:.0e})",
              flush=True)
        require(np.isfinite(out["v1 loop"]) and err <= ROUTE_RTOL["bfloat16"],
                f"sweep loops: v1 and v2 disagree ({err:.3e})")
        t, tflops = sweep_iter2.mxu_probe(0)
        runs["tensor-core probe"] = {"ms": 1e3 * t, "tflops": tflops}
        print(f"  tensor-core probe (2048x65536x2048 bf16, torch.matmul): {1e3 * t:.3f} ms, "
              f"{tflops:.1f} TFLOP/s (published dense bf16 peak 989; {card})", flush=True)

    def int8_path():
        # sweep_int8's loop against the f32 single-pass loop from one init
        x, xq, scale, w0, h0 = sweep_data["int8"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wq, hq, _ = sweep_int8.make_run(128)(xq, scale, w0, h0, SWEEP_ITERS)
        torch.cuda.synchronize()
        secs_q = time.perf_counter() - t0
        t0 = time.perf_counter()
        wf, hf = sweep_int8.run_f32(x, w0, h0, SWEEP_ITERS)
        torch.cuda.synchronize()
        secs_f = time.perf_counter() - t0
        obj_q, obj_f = sweep_int8.objective(x, wq, hq), sweep_int8.objective(x, wf, hf)
        dev = (obj_q - obj_f) / obj_f
        runs["sweep int8 loop"] = {"it_s": SWEEP_ITERS / secs_q, "f32_it_s": SWEEP_ITERS / secs_f,
                                   "obj_int8": obj_q, "obj_f32": obj_f, "rel_dev": dev}
        print(f"  sweep int8 loop {tuple(xq.shape)} r128: {SWEEP_ITERS / secs_q:.2f} it/s, f32 "
              f"single-pass loop {SWEEP_ITERS / secs_f:.2f} it/s (wall clock; {card}); objective "
              f"after {SWEEP_ITERS}: int8 {obj_q:.6e} vs f32 {obj_f:.6e} (rel dev {dev:+.3%})",
              flush=True)
        require(all(bool(torch.isfinite(a).all()) for a in (wq, hq, wf, hf))
                and np.isfinite(obj_q) and np.isfinite(obj_f), "sweep int8: non-finite result")

    def rate_path():
        rate = read_probe.read_rate(eu_x)
        runs["read rate"] = {"bytes_per_s": rate}
        print(f"  read rate of {tuple(eu_x.shape)} f32 (read_probe, 110 less 10 calls): "
              f"{rate / 1e12:.3f} TB/s against the published 3.35 ({card})", flush=True)
        require(np.isfinite(rate) and rate > 0, f"read rate {rate}")

    def drive(label, needed, body, opt_in=False, exact=None):
        out, launched = run_path(torch, counters, label, needed, body)
        for name, c in launched.items():
            launches[name] += c
        if exact is not None:  # exactly these launches, none of any other kernel
            for name, c in launched.items():
                require(c == exact.get(name, 0),
                        f"{label}: {name} launched {c} times, not {exact.get(name, 0)}")
            return out
        # the switches at tpunmf's defaults; no NMF path reaches the sweeps' kernels
        for name in (() if opt_in else OPT_IN) + SWEEP_ONLY:
            require(launched[name] == 0, f"{label}: {name} was launched off its path")
        return out

    def profile_path():
        # where the time goes on both routes, at the single pass's shapes
        for label, x, k, dist in (("EU f32", eu_x, eu_k, "eu"),
                                  ("KL 8192x4096", kl2_x, KL_SINGLE["k"], "kl")):
            profiles[label] = profile_run(torch, tt, label, x, k, dist)
            with two_pass_route():
                profiles[label + " 2-pass"] = profile_run(torch, tt, label + " 2-pass", x,
                                                          k, dist)
        # MUR KL at config[1] (the pair, exact objective) on both routes
        profiles["KL config[1]"] = profile_run(torch, tt, "KL config[1]", kl_x, kl_k, "kl")
        profiles["KL config[1] plain"] = profile_run(torch, tt, "KL config[1] plain", kl_x,
                                                     kl_k, "kl", plain=True)
        # and on the high-rank step and the plain route at its shapes
        for label, x, dist in ((f"KL 8192x4096 k{HIGH_RANK}", kl2_x, "kl"),
                               (f"EU 8192x8192 k{HIGH_RANK}", eu_x, "eu")):
            profiles[label] = profile_run(torch, tt, label, x, HIGH_RANK, dist)
            profiles[label + " plain"] = profile_run(torch, tt, label + " plain", x,
                                                     HIGH_RANK, dist, plain=True)

    profiles, hals_init = {}, []
    for label, needed, body in (
            ("MUR path", ("mur_w_update", "mur_h_update", "eu_residual_obj", "kl_obj",
                          "mur_iteration_eu", "mur_iteration_kl"), mur_path),
            ("high-rank MUR path", ("kl_ratio", "kl_ratio_and_obj", "eu_residual_obj"),
             high_rank_path),
            ("NMF(numpy float64) path", SINGLE_EU + PAIR + ("kl_obj", "gs_sweep",
                                                            "masked_w_update"), numpy_path),
            ("HALS path", ("gs_sweep", "eu_residual_obj"), hals_path),
            ("masked MUR path", ("masked_w_update", "masked_h_update"), masked_path),
            ("lagged KL path", ("mur_w_update_lagged", "mur_h_update", "mur_iteration_kl"),
             lagged_path),
            ("profile of the MUR routes", ("mur_iteration_eu", "mur_iteration_kl",
                                           "kl_ratio"), profile_path)):
        drive(label, needed, body)
    drive("HALS single-pass path", ("hals_iteration_eu", "gs_sweep", "eu_residual_obj"),
          hals_single_path, opt_in=True)
    drive("MUR EU dma path", ("mur_iteration_eu_dma", "eu_residual_obj"), mur_dma_path,
          opt_in=True)
    _, launched = run_path(torch, counters, "CUDA float64 tensor path", (),
                           float64_tensor_path)
    require(sum(launched.values()) == 0, "a CUDA float64 tensor launched a kernel")
    # where the time goes on the masked paths, both routes (after the paths'
    # counts were read: these launches are not a path's)
    for dist in ("eu", "kl"):
        label = f"masked {dist.upper()} ML-10M"
        profiles[label] = profile_run(torch, tt, label, ml10_x, 64, dist, mask=ml10_obs)
        profiles[label + " plain"] = profile_run(torch, tt, label + " plain", ml10_x, 64, dist,
                                                 plain=True, mask=ml10_obs)
    # the ADMM KL path holds ~10 config[3]-sized arrays (4 GB each)
    del ml10_x, ml10_obs, ml1_x, wide_x
    kept = drive("serving path", ("score_blockmax_relayout", "blockmax_relayout"),
                 lambda: serving_path(torch, runs))
    check_serving(torch, runs, kept)
    profile_serving(torch, runs, kept["requests"])
    del kept
    torch.cuda.empty_cache()
    drive("ADMM path", ("eu_residual_obj", "kl_ratio_and_obj"), admm_path)
    for dist in ("eu", "kl"):
        for plain in (False, True):
            label = f"ADMM {dist.upper()} config[3]" + (" plain" if plain else "")
            profiles[label] = profile_run(torch, tt, label, adm_x, CONFIG3["k"], dist,
                                          plain=plain, method="admm", distance_type=dist,
                                          rho_mode="fixed", **ADMM_KW)
    del adm_x
    torch.cuda.empty_cache()
    # the sweep scripts' data and warm-up runs (2 iterations each), before
    # their paths' counts are reset
    x2, w2, h2 = sweep_iter2.problem(0)
    x8, w8, h8 = sweep_int8.problem(0)
    sweep_data = {"iter2": (x2, w2, h2), "int8": (x8, *sweep_int8.quantize(x8), w8, h8)}
    sweep_iter2.make_v1(128)(x2, w2, h2, 2)
    sweep_iter2.make_v2(128)(x2, w2, h2, 2)
    sweep_int8.make_run(128)(*sweep_data["int8"][1:], 2)
    sweep_int8.run_f32(x8, w8, h8, 2)
    drive("sweep_iter2 path", ("v1_iter", "v2_iter"), sweep_path,
          exact={"v1_iter": SWEEP_ITERS, "v2_iter": SWEEP_ITERS})
    drive("sweep_int8 path", ("iter_eu_int8", "mur_iteration_eu"), int8_path,
          exact={"iter_eu_int8": SWEEP_ITERS, "mur_iteration_eu": SWEEP_ITERS})
    drive("read-rate path", ("read_probe",), rate_path, exact={"read_probe": 3 * (10 + 110)})
    print(f"  launches over the paths: {launches}", flush=True)
    for name, c in launches.items():
        require(c > 0, f"{name} was not launched on any path")
    print(f"  phase 3 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print("phase 4: save/load", flush=True)
    roundtrip_phase(tt, ragged, 8)
    print(f"  phase 4 took {time.perf_counter() - t_phase:.1f} s; all phases "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def headline(name):
        want = HEADLINE.get(name, "EU") + " "
        hits = [c for c in records[name]["cases"] if c["shape"].startswith(want)
                and c["shape"].endswith(HEADLINE_X.get(name, "f32"))]
        return hits[0]

    # library_ms: only blockmax_relayout (torch.amax over the view of the
    # scores that its s3 is) and the read probe (torch.sum over rows) have
    # one PyTorch call computing their function, timed in turns with the
    # kernel as ms is with the plain version; their device times are in
    # their cases.  The others fuse a product with an update, a masked
    # sum, a division or a selection, and have none (null)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": records[name]["max_abs_err"],
         "ms": headline(name)["ms"],
         "plain_ms": headline(name)["plain_ms"],
         "bound_ms": headline(name)["bound_ms"], "bound_by": headline(name)["bound_by"],
         "library_ms": headline(name)["library_ms"],
         "shape": headline(name)["shape"] + " " + headline(name)["case"],
         "cases": records[name]["cases"]}
        for name, (src, rep) in KERNELS.items()],
        "runs": {label: {k: v for k, v in r.items() if k != "trace"}
                 for label, r in runs.items()},
        "torch_topk": topk_line, "single_vs_pair": route_line, "dma_vs_auto": dma_line,
        "v1_vs_auto": v1_line,
        "profiles": profiles}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
