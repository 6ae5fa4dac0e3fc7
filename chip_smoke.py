#!/usr/bin/env python3
"""Drive tpunmf_torch's main paths once on one CUDA card, through its kernels.

    python3 chip_smoke.py       # one card; 75-95 s of command time on an H100

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. the card's name and power limit; build the CUDA kernels of
     tpunmf_torch/ops/csrc with nvcc (sm_90a) and print the build time.
  2. each kernel against its plain PyTorch version on the card, at the
     paths' shapes and ragged ones: the error against a stated tolerance,
     and both times (CUDA events, in the order plain, kernel, kernel,
     plain).
  3. the paths through tpunmf_torch.NMF(...).factorize, exactly 50
     iterations each, the kernel route against the plain route on the card:
     - MUR: EU at 8192x8192 r128 (lowrank_dense) with bf16 and f32 X, and
       KL at its defaults (random init, exact objective) on BASELINE
       config[1], 20000x11000 r50 (tfidf_like, seed 1);
     - HALS (method="hals"): EU 8192x8192 r128 f32, inner_sweeps=2, from
       one NNDSVD 'zero' init given to both routes;
     - masked MUR (mask=): EU and KL at MovieLens-10M's dimensions, 69878
       users x 10677 items, 1.34% observed, r64 (movielens_like's recipe,
       made on the card);
     - MUR KL with objective="lagged" at config[1], against the exact run.
     Each path's launch counters are set to 0 just before it and read just
     after; each run must launch its kernels and give finite factors and
     trace (non-increasing for EU).
  4. a save_factorization / load_factorization round trip.
Then one JSON line of the kernels, the nvidia-smi line, and the result
line.  Without a CUDA card, or without the tpunmf_torch package beside
this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

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
# lagged[i+1] against the exact route's exact[i]: the same KL sums, one
# from the W pass's tiles and one from the objective kernel's
LAGGED_RTOL = 1e-4
# MovieLens-10M: 10,000,054 ratings of 69,878 users on 10,677 items
ML10M = (69878, 10677, 0.0134)

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
}
# the shape whose times the kernels line reports (its f32 case)
HEADLINE = {"kl_obj": "KL", "mur_w_update_lagged": "KL",
            "masked_w_update": "ML-10M", "masked_h_update": "ML-10M"}


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


def max_rel_err(got, want):
    got, want = got.double(), want.double()
    denom = want.abs().clamp_min(float(np.finfo(np.float32).tiny))
    return float(((got - want).abs() / denom).max())


def scaled_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def check_kernel(torch, records, name, label, what, kern, plain, rtol, reps,
                 err=max_rel_err):
    """One kernel call against its plain version on the same inputs: the
    error (over every output) against rtol, and both times."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rel = max(err(a, b) for a, b in zip(got, want))
    abs_err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ms, plain_ms = time_pair(torch, plain, kern, reps)
    ok = finite and rel <= rtol
    print(f"  {name:19s} {label:30s} {what:24s} err={rel:.3e} "
          f"(tol {rtol:.0e}) max_abs_err={abs_err:.3e} "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(finite, f"{name} {label} {what}: non-finite output")
    require(rel <= rtol, f"{name} {label} {what}: error {rel:.3e} above {rtol:.0e}")
    rec = records.setdefault(name, {"max_abs_err": 0.0, "cases": []})
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    rec["cases"].append({"shape": label, "case": what, "max_rel_err": rel,
                         "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms})


def kernel_phase(torch, cases, reps):
    """Compare every kernel of the MUR path with its plain version; returns
    per-kernel records.  Launches here do not count toward a path's."""
    from tpunmf_torch.ops import fused, mur_fused

    records = {}
    for label, x, k, distances in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(7)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        checks = []
        for dist in distances:
            for lam in (0.0, 0.2):
                checks.append((
                    "mur_w_update", f"{dist} lam={lam}",
                    lambda d=dist, l=lam: mur_fused.mur_w_update(
                        x, w, h, distance_type=d, lam=l),
                    lambda d=dist, l=lam: mur_fused.mur_w_update_ref(
                        x, w, h, distance_type=d, lam=l), UPDATE_RTOL))
                checks.append((
                    "mur_h_update", f"{dist} lam={lam}",
                    lambda d=dist, l=lam: mur_fused.mur_h_update(
                        x, w, h, distance_type=d, lam=l),
                    lambda d=dist, l=lam: mur_fused.mur_h_update_ref(
                        x, w, h, distance_type=d, lam=l), UPDATE_RTOL))
            obj = "eu_residual_obj" if dist == "eu" else "kl_obj"
            checks.append((obj, dist, lambda o=obj: getattr(fused, o)(x, w, h),
                           lambda o=obj: getattr(fused, o + "_ref")(x, w, h),
                           OBJECTIVE_RTOL))
        for name, what, kern, plain, rtol in checks:
            check_kernel(torch, records, name, label, what, kern, plain, rtol, reps)
        del w, h
    return records


def lagged_phase(torch, records, x, k, label, reps):
    """The lagged W pass against its plain version: the new W, and the
    objective against the plain masked KL of the incoming (W, H) (the
    formula of fused.kl_obj_ref)."""
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
                     UPDATE_RTOL, reps)


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
                    check_kernel(torch, records, "gs_sweep", label,
                                 f"{frame} lam={lam} sweeps={nsweeps}",
                                 lambda: hals_sweep.gs_sweep(a, gram, v, **kw),
                                 lambda: hals_sweep.gs_sweep_ref(a, gram, v, **kw),
                                 SWEEP_TOL, reps, err=scaled_err)
        del w, h, frames


def masked_phase(torch, records, cases, reps):
    """masked_w_update / masked_h_update against their plain versions:
    EU and KL, lam 0 and 0.2, a 1-byte binary mask and an f32 weight
    mask, each with a fully unobserved row and column."""
    from tpunmf_torch.ops import masked_fused as mf

    for label, x, observed, k in cases:
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
                    check_kernel(torch, records, "masked_w_update", label, what,
                                 lambda: mf.masked_w_update(x, mask, w, h, **kw),
                                 lambda: mf.masked_w_update_ref(x, mask, w, h, **kw),
                                 UPDATE_RTOL, reps)
                    check_kernel(torch, records, "masked_h_update", label, what,
                                 lambda: mf.masked_h_update(x, mask, w, h, **kw),
                                 lambda: mf.masked_h_update_ref(x, mask, w, h, **kw),
                                 UPDATE_RTOL, reps)
        del w, h, binary, weights


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
              iters, method="mur", needed=None, **extra):
    """One NMF run of `iters` iterations on the fused route, and the plain
    route over the same run for comparison; returns the rates, the routes'
    agreement and the fused route's trace."""
    kw = dict(method=method, min_iter=iters, max_iter=iters, **extra)
    if method == "mur":
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
    if distance == "eu":
        rises = np.diff(hist) / hist[:-1]
        require(np.all(rises <= EU_MONOTONE_RTOL),
                f"{label}: EU objective rose by {rises.max():.3e}")
    if needed is None:
        needed = ("mur_w_update", "mur_h_update",
                  "kl_obj" if distance == "kl" else "eu_residual_obj")
    for name in needed:
        require(launched[name] > 0, f"{label}: {name} was not launched")
    return {"fused_it_s": iters / fused_s, "plain_it_s": iters / plain_s,
            "route_err": route_err, "trace": hist.tolist()}


def lagged_run(torch, tt, label, x, k, exact_trace, iters, card):
    """MUR KL with objective='lagged' on the kernel route: its trace is the
    exact route's shifted by one iteration."""
    kw = dict(method="mur", distance_type="kl", min_iter=iters, max_iter=iters,
              objective="lagged")
    tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tt.NMF(x, k).factorize(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
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
    from tpunmf_torch.ops import _build, fused, hals_sweep, masked_fused, mur_fused

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"mur_w_update": (mur_fused.mur_w_update, "launches"),
                "mur_h_update": (mur_fused.mur_h_update, "launches"),
                "eu_residual_obj": (fused.eu_residual_obj, "launches"),
                "kl_obj": (fused.kl_obj, "launches"),
                "mur_w_update_lagged": (mur_fused.mur_w_update, "lagged_launches"),
                "gs_sweep": (hals_sweep.gs_sweep, "launches"),
                "masked_w_update": (masked_fused.masked_w_update, "launches"),
                "masked_h_update": (masked_fused.masked_h_update, "launches")}

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    print(f"phase 1: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()  # builds from tpunmf_torch/ops/csrc on first use
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    eu_x = torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda()
    kl_x = torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()
    eu_k, kl_k = 128, 50
    ragged = torch.from_numpy(
        tfidf_like(1000, 777, n_topics=37, seed=2) + 0.05).cuda()
    ragged[::7, ::5] = 0.0  # exact zeros for the KL masking
    print(f"  data made in {time.perf_counter() - t0:.1f} s: EU {tuple(eu_x.shape)}, "
          f"KL {tuple(kl_x.shape)} ({float((kl_x == 0).float().mean()):.4f} zeros)",
          flush=True)
    t0 = time.perf_counter()
    # BASELINE config[2]'s MovieLens-1M stand-in (benchmarks/run_configs.py:151-155)
    ml1_x = torch.from_numpy(movielens_like(6040, 3706, density=0.2, seed=2)).cuda()
    ml10_x, ml10_obs = movielens_on_card(torch, *ML10M, seed=3)
    torch.cuda.synchronize()
    print(f"  MovieLens-shaped data made in {time.perf_counter() - t0:.1f} s: "
          f"{tuple(ml1_x.shape)} {float((ml1_x > 0).float().mean()):.4f} observed; "
          f"{tuple(ml10_x.shape)} {int(ml10_obs.sum())} observed", flush=True)

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
    lagged_phase(torch, records, ragged, 37, f"ragged {tuple(ragged.shape)} k37 f32", 5)
    lagged_phase(torch, records, kl_x, kl_k, f"KL {tuple(kl_x.shape)} k{kl_k} f32", 5)
    sweep_phase(torch, records, [
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37),
        (f"EU {tuple(eu_x.shape)} k{eu_k} f32", eu_x, eu_k)], reps=3)
    masked_phase(torch, records, [
        (f"ML-1M {tuple(ml1_x.shape)} k64 f32", ml1_x, ml1_x > 0, 64),
        (f"ML-10M {tuple(ml10_x.shape)} k64 f32", ml10_x, ml10_obs, 64)], reps=3)
    print(f"  phase 2 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print("phase 3: the paths through NMF.factorize", flush=True)
    runs, launches = {}, {name: 0 for name in KERNELS}

    def mur_path():
        for label, x, k, dist, dd in (
                ("EU bf16", eu_x, eu_k, "eu", torch.bfloat16),
                ("EU f32", eu_x, eu_k, "eu", None),
                ("KL config[1]", kl_x, kl_k, "kl", None)):
            runs[label] = run_slice(torch, tt, counters, label, x, k, dist, dd,
                                    card, RUN_ITERS)

    def hals_path():
        t0 = time.perf_counter()
        # NNDSVD 'zero' once for both routes, nudged to 1e-16 as hals()
        # nudges the inits it makes (tpunmf/solvers/hals.py:221-225)
        w0, h0 = nndsvd(eu_x, eu_k, variant="zero")
        w0, h0 = w0.clamp(min=1e-16).contiguous(), h0.clamp(min=1e-16).contiguous()
        torch.cuda.synchronize()
        print(f"  HALS: NNDSVD 'zero' init in {time.perf_counter() - t0:.1f} s", flush=True)
        runs["HALS EU f32"] = run_slice(
            torch, tt, counters, "HALS EU f32", eu_x, eu_k, "eu", None, card,
            RUN_ITERS, method="hals", needed=("gs_sweep", "eu_residual_obj"),
            inner_sweeps=2, w_init=w0, h_init=h0)

    def masked_path():
        for dist in ("eu", "kl"):
            label = f"masked {dist.upper()} ML-10M"
            runs[label] = run_slice(
                torch, tt, counters, label, ml10_x, 64, dist, None, card, RUN_ITERS,
                needed=("masked_w_update", "masked_h_update"), mask=ml10_obs)

    def lagged_path():
        runs["KL config[1] lagged"] = lagged_run(
            torch, tt, "KL config[1] lagged", kl_x, kl_k,
            runs["KL config[1]"]["trace"], RUN_ITERS, card)

    for label, needed, body in (
            ("MUR path", ("mur_w_update", "mur_h_update", "eu_residual_obj", "kl_obj"),
             mur_path),
            ("HALS path", ("gs_sweep", "eu_residual_obj"), hals_path),
            ("masked MUR path", ("masked_w_update", "masked_h_update"), masked_path),
            ("lagged KL path", ("mur_w_update_lagged", "mur_h_update"), lagged_path)):
        _, launched = run_path(torch, counters, label, needed, body)
        for name, c in launched.items():
            launches[name] += c
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
        hits = [c for c in records[name]["cases"]
                if c["shape"].startswith(want) and c["shape"].endswith("f32")]
        return hits[0]

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": records[name]["max_abs_err"],
         "ms": headline(name)["ms"], "plain_ms": headline(name)["plain_ms"],
         "shape": headline(name)["shape"] + " " + headline(name)["case"],
         "cases": records[name]["cases"]}
        for name, (src, rep) in KERNELS.items()],
        "runs": {label: {k: v for k, v in r.items() if k != "trace"}
                 for label, r in runs.items()}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
