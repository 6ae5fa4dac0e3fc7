#!/usr/bin/env python3
"""Time the MUR passes, the masked passes and the objective passes on one
CUDA card, alone and in turns with the same kernels of another checkout.

    python3 tools/kernel_turns.py [--parent DIR]
        [--only mur|w|kl|single|dma|int8|score|sweep|masked|objectives|gram]

DIR is a checkout of another commit (for instance the parent, unpacked
with ``git archive`` into a git-ignored directory); its kernels are built
from its own ``tpunmf_torch/ops/csrc`` and called through its own C
entries.  Each case prints the ms of one call (CUDA events, the mean of
``reps`` calls back to back after a warm-up call, host launch path
included, as chip_smoke.py times a kernel alone), and with DIR the other
checkout's ms in turns (other, this, this, other; each sample at least
20 ms of calls, so that a few tens of microseconds of host jitter do not
decide the ratio of a call well under a millisecond) and their ratio, on
the card named by nvidia-smi.  For the W passes (mur_w_update,
masked_w_update) the turns call this checkout's C entry just as the
other's is called, so that the wrapper's host time, a tenth of a call
at MovieLens-1M's shape, does not count against one side alone.  With DIR,
``--only masked`` also compares the machine code (cuobjdump's SASS) of
each instantiation of the masked W kernel in the two libraries.

Cases, on chip_smoke.py's data recipes:
  - mur_w_update (``--only w`` runs these alone): EU at 8192 x 8192 r128
    (f32 and bf16 X) and 8192 x 16384 r128 (lowrank_dense, seed 0); KL
    and lagged KL at BASELINE config[1]; KL at 8192 x 4096 (tfidf_like
    seed 4) at k 128, 256, 320, 384, 448, 512, 640 and 768, across the
    tensor-core rank line; each also with its profiler device time (and
    the other's);
  - mur_iteration_eu at 8192 x 8192 r128 (lowrank_dense, seed 0), f32 and
    bf16 X, and at 8192 x 32768 r32, 8192 x 16384 r64 and 16384 x 4096
    r256 (lowrank_dense of rank min(k, 64)); mur_h_update's EU body at
    8192 x 8192 r128 (f32 and bf16 X, and at f32 over 1, 4, 8 and 16 row
    splits, this checkout's only) and its KL body at BASELINE config[1]
    (20000 x 11000 r50, tfidf_like seed 1) and at 8192 x 4096 (tfidf_like
    seed 4) at k 128, 256, 512, 640, 768 and 1024, where the other
    checkout's C entry (the FMA body before the tensor cores) is called
    with its own signature where that differs;
  - masked_h_update at MovieLens-10M's shape, EU and KL at k 64, also held
    to the other checkout's bits;
  - masked_w_update at MovieLens-10M's shape (69878 x 10677, 1.34%
    observed, uint8 mask): EU and KL at k 64, also held to the other
    checkout's bits; EU at k 256 and 1024; and at
    MovieLens-1M's (6040 x 3706, 20% observed) EU and KL at k 64.  At k 64
    also the variants of this checkout's kernel through its C entry: 64-
    and 32-row blocks, H in place (4-byte copies, as n % 4 != 0) and
    through a padded copy made once;
  - eu_residual_obj at 8192 x 8192 r128 and r1536 and at BASELINE
    config[3] (50000 x 20000 r128); kl_obj at config[1] (20000 x 11000
    r50), 8192 x 4096 r1536 and one card's cut of BASELINE config[4]
    (50000 x 20000 r256, chip_smoke.config4_on_card); kl_ratio_and_obj
    at config[3].
With --only kl, MUR's KL passes on the tensor cores alone: mur_w_update KL
and lagged KL and mur_h_update KL at BASELINE config[1] and at 8192 x 4096
r128 (tfidf_like seed 4), and mur_iteration_kl at 8192 x 4096 r128 through
both sides' C entries, with device times.
With --only single, the two single passes alone, each side through its
own C entry with its buffers made once: mur_iteration_kl at 8192 x 4096
r128 (tfidf_like seed 4, f32 and bf16 X) and at 8192 x 1024 (tfidf_like
seed 4) at k 256, 384, 448, 512, 768 and 1024, across the KL rank lines
(this checkout's entry of the pair's bodies at every k, which the wrapper
takes up to mur_fused.KL_ITER_PAIR_RANK);
hals_iteration_eu at 8192 x 8192 r128 (lowrank_dense seed 0) f32 at 2
and 1 sweeps and bf16 at 2; each also with its profiler device time (and
the other's).
With --only dma, the EU pass on TMA and wgmma: mur_iteration_eu_dma and
v1_iter, each side through its own C entry with its buffers made once
(before the TMA stages the other checkout's entries took H in X's type,
or H^T, and the FMA plan's scratch), and mur_iteration_eu (this
checkout's wrapper, the other's C entry), at 8192 x 8192 r128
(lowrank_dense seed 0) and 8192 x 16384 r128, 8192 x 32768 r32, 16384 x
4096 r256 and 8192 x 8190 r128 (rows off 16 bytes: the kernel's own loads
of X; lowrank_dense of rank min(k, 64)), f32 and bf16 X, with the
profiler's device times of the dma variant.
With --only int8, iter_eu_int8, each side through its own C entry with
its buffers made once (before the TMA stages the other checkout's entry
took H in f32 and the FMA plan's scratch, kind 0, and no scratch length),
at 8192 x 8192 r128 and 8192 x 16384 r128 (lowrank_dense seed 0, + 0.05,
quantised as sweep_int8.py does), 8192 x 8188 r128 and 8192 x 8190 r128
(X's rows off 16 and off 4 bytes: the producer's copies of their covering
chunks; before this tree, 4-byte copies and plain loads), with the
profiler's device times and the largest relative difference of the two
sides' outputs.
With --only score, score_blockmax_relayout the same way (before TMA and
wgmma the other checkout's entry took W in f32 and no W operands), at
chip_smoke.py's phase-2 scoring shapes: (64, 128) x (128, 2^20) f32 and
bf16 (W and H both bf16: serving's quantized first stage), (64, 512) x
(512, 2^19) f32, (96, 128) x (128, 40000) f32, (8, 64) x (64, 40001)
f32 and bf16 and (64, 128) x (128, 2^20 + 2) f32 (H's rows off 16 bytes:
the producer's copies of their covering chunks), with the profiler's device
times and the largest difference of the two sides' scores, relative to 1
+ |score|.
With --only sweep, gs_sweep through both sides' C entries over 8192
columns (lowrank_dense seed 0 at rank 64, random factors) in the W frame
(transposed views) and the H frame, at 0, 1 and 2 sweeps and k 37, 128,
264, 513 and 1024, with the profiler's device times, the bound and its
share, and the largest difference of the two sides' outputs; then
hals_iteration_eu at 8192 x 8192 r128 f32 (lowrank_dense seed 0) with 2
and 1 sweeps the same way.
With --only gram, no times: the Gram objective near convergence of
tests/test_torch_cuda.py (2000 x 1500 r64, six seeds) from this
checkout's mur_iteration_eu and mur_h_update and, with DIR, the other's,
beside cuBLAS's f32 products, each as its error against float64 in units
in the last place of ||X||^2.
Needs the card; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import difflib
import importlib.util
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def other_library(checkout):
    """The kernels' library of another checkout, built from its sources by
    its own ops/_build.py."""
    path = os.path.join(checkout, "tpunmf_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def sass_of(lib_path, kernel):
    """{mangled template arguments: SASS lines} of each instantiation of
    ``kernel`` in the library at lib_path, from cuobjdump: two lines an
    instruction (its text and encoding, then the rest of the encoding,
    with the scheduling bits), runs of blanks made one; None where
    cuobjdump is missing.  The keys leave out the namespace, whose
    anonymous part differs between builds."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    dump = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs, key = {}, None
    for line in dump.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            key = name[name.index(kernel):] if kernel in name else None
            if key is not None:
                funcs[key] = []
        elif key is not None and "/*" in line:
            funcs[key].append(" ".join(line.split()))
    return funcs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose kernels to time in turns")
    ap.add_argument("--only",
                    choices=("mur", "w", "kl", "single", "dma", "int8", "score", "sweep",
                             "masked", "objectives", "gram"),
                    help="time one family of cases (w: the MUR W pass alone, a part of "
                         "mur; kl: MUR's KL passes on the tensor cores and "
                         "mur_iteration_kl; single: mur_iteration_kl and "
                         "hals_iteration_eu; dma: "
                         "mur_iteration_eu_dma, v1_iter and mur_iteration_eu; int8: "
                         "iter_eu_int8; score: score_blockmax_relayout; sweep: gs_sweep "
                         "and hals_iteration_eu; gram: accuracy, no times)")
    args = ap.parse_args()

    import chip_smoke as cs
    from tpunmf_torch.data import lowrank_dense, movielens_like, tfidf_like
    from tpunmf_torch.ops import _build, _launch, fused, mur_fused, mur_variants, topk_select
    from tpunmf_torch.ops import masked_fused as mf
    from tpunmf_torch.sweeps import sweep_int8

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    lib = _build.library()
    other = other_library(args.parent) if args.parent else None

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def report(label, this_fn, other_fn, reps, this_entry=None):
        """this_fn alone; with other_fn, in turns with this_entry (this
        checkout's C entry, called as other_fn calls the other's) or, where
        there is none, with this_fn."""
        ms = cs.time_pair(torch, this_fn, this_fn, reps)[0]
        line = f"  {label:44s} this {ms:9.4f} ms"
        if other_fn is not None:
            turns_reps = max(reps, math.ceil(20.0 / ms))
            this_ms, other_ms = cs.time_pair(torch, other_fn, this_entry or this_fn,
                                             turns_reps)
            turns = "in turns, C entries" if this_entry else "in turns"
            line += (f"   {turns}: this {this_ms:9.4f} ms, other {other_ms:9.4f} ms, "
                     f"other / this {other_ms / this_ms:.3f}")
        print(line, flush=True)

    def factors(m, n, k, seed):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        return (torch.rand((m, k), generator=g, device="cuda") + 0.1,
                torch.rand((k, n), generator=g, device="cuda") + 0.1)

    # ------------------------------------------------------- the MUR passes
    def iteration_case(label, x, k, reps=3):
        m, n = x.shape
        w, h = factors(m, n, k, 14)
        bm = mur_fused.iter_eu_tileable(x, k) or m

        def this_fn():
            return mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=bm)

        other_fn = None
        if other is not None:
            def other_fn():  # the other checkout's entry: EU single pass, lam_w = 0
                return other_iteration_eu(x, w, h)
        report(f"mur_iteration_eu {label} k{k}", this_fn, other_fn, reps)

    def other_iteration_eu(x, w, h):
        """The other checkout's mur_iteration_eu, as its wrapper calls it,
        with scratch for either plan (kind 0 before the tensor cores, 3
        since)."""
        m, n = x.shape
        k = w.shape[1]
        gh, hc = h @ h.T, h.to(x.dtype)
        outs = (torch.empty_like(w), torch.empty_like(h), torch.empty_like(gh))
        count = max(other.tpunmf_iteration_scratch(m, n, k, x.element_size(), kind)
                    for kind in (0, 3))
        scratch = torch.empty(max(count, 1), device="cuda")
        # before the TMA stages the entry took a dma flag (0: the tensor cores)
        dma = (0,) if len(other.tpunmf_mur_iteration_eu.argtypes) == 15 else ()
        _build.check(other.tpunmf_mur_iteration_eu(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), hc.data_ptr(),
            gh.data_ptr(), 0.0, m, n, k, *(o.data_ptr() for o in outs), scratch.data_ptr(),
            *dma, stream()), "other")
        return outs

    def other_h_update(x, w, h, dist, splits=1):
        """The other checkout's mur_h_update, as its wrapper calls it
        (``splits`` row splits where its entry takes splits)."""
        m, n = x.shape
        k = w.shape[1]
        is_kl = int(dist == "kl")
        aux = torch.sum(w, dim=0) if is_kl else w.T @ w
        h_out, numer = torch.empty_like(h), torch.empty_like(h)
        part = (torch.empty(mur_fused.h_scratch_floats(splits, n, k) or 1, device="cuda")
                if splits > 1 else numer)
        extra = ((part.data_ptr(), splits) if len(other.tpunmf_mur_h_update.argtypes) == 15
                 else ())  # part, splits
        _build.check(other.tpunmf_mur_h_update(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr(),
            aux.data_ptr(), 0.0, m, n, k, is_kl, *extra, h_out.data_ptr(), numer.data_ptr(),
            stream()), "other")
        return h_out, numer

    def w_entry(lib_, x, w, h, dist, lagged=False):
        """mur_w_update through the C entries of ``lib_``, as the wrapper
        calls them; before the tensor-core W pass the entries took no H
        stride, splits or scratch, and EU took H in f32."""
        m, n = x.shape
        k = w.shape[1]
        is_bf16, is_kl = int(x.dtype == torch.bfloat16), dist == "kl"
        aux = torch.sum(h, dim=1) if is_kl else h @ h.T
        out = torch.empty_like(w)
        if len(lib_.tpunmf_mur_w_update.argtypes) == 12:
            head = (x.data_ptr(), is_bf16, w.data_ptr(), h.data_ptr(), aux.data_ptr(), 0.0,
                    m, n, k)
            if lagged:
                parts = torch.empty(lib_.tpunmf_mur_w_lagged_blocks(m, k), device="cuda")
                obj = torch.empty((), device="cuda")
                _build.check(lib_.tpunmf_mur_w_update_lagged(
                    *head, out.data_ptr(), parts.data_ptr(), obj.data_ptr(), stream()), "w")
                return out, obj
            _build.check(lib_.tpunmf_mur_w_update(*head, int(is_kl), out.data_ptr(),
                                                  stream()), "w")
            return out
        tc = is_kl and mur_fused.kl_w_on_tensor_cores(k)
        splits = mur_fused.w_splits(m, n, k) if tc else 1
        ldh = mf.h_stride(n) if tc else n
        hh = (h.to(x.dtype) if not is_kl else
              torch.nn.functional.pad(h, (0, ldh - n)) if ldh != n else h)
        floats = (mur_fused.w_scratch_floats(splits, m, k) if is_kl
                  else lib_.tpunmf_mur_w_eu_scratch(m, n, k, x.element_size()))
        buf = torch.empty(max(floats, 1), device="cuda")
        head = (x.data_ptr(), is_bf16, w.data_ptr(), hh.data_ptr(), ldh, aux.data_ptr(), 0.0,
                m, n, k)
        tail = (splits, buf.data_ptr(), floats, out.data_ptr())
        if lagged:
            parts = torch.empty(lib_.tpunmf_mur_w_lagged_blocks(m, k, splits), device="cuda")
            obj = torch.empty((), device="cuda")
            _build.check(lib_.tpunmf_mur_w_update_lagged(
                *head, *tail, parts.data_ptr(), obj.data_ptr(), stream()), "w")
            return out, obj
        _build.check(lib_.tpunmf_mur_w_update(*head, int(is_kl), *tail, stream()), "w")
        return out

    def w_case(label, x, k, dist, reps=3, lagged=False):
        m, n = x.shape
        w, h = factors(m, n, k, 14)

        def this_fn():
            return mur_fused.mur_w_update(x, w, h, distance_type=dist, lam=0.0,
                                          with_lagged_obj=lagged)

        other_fn = None
        if other is not None:
            def other_fn():
                return w_entry(other, x, w, h, dist, lagged)
        tc = dist == "kl" and mur_fused.kl_w_on_tensor_cores(k)
        shape = (f", 64-row blocks, {mur_fused.w_splits(m, n, k)} splits" if tc
                 else "" if dist == "eu" else ", FMA")
        report(f"mur_w_update {dist}{' lagged' if lagged else ''} {label} k{k}{shape}",
               this_fn, other_fn, reps, lambda: w_entry(lib, x, w, h, dist, lagged))
        device = cs.device_ms(torch, this_fn, 10)
        line = f"    device time (profiler, 10 calls): this {device:.4f} ms"
        if other_fn is not None:
            line += f", other {cs.device_ms(torch, other_fn, 10):.4f} ms"
        print(line, flush=True)

    def h_case(label, x, k, dist, reps=3, splits=(None,)):
        m, n = x.shape
        w, h = factors(m, n, k, 14)
        other_fn = None
        if other is not None:
            def other_fn():  # the wrapper's own split count, where the entry takes one
                return other_h_update(x, w, h, dist, mur_fused.h_splits(m, n, k, dist))
        for sp in splits:
            def this_fn(sp=sp):
                return mur_fused.mur_h_update(x, w, h, distance_type=dist, lam=0.0, splits=sp)
            count = mur_fused.h_splits(m, n, k, dist) if sp is None else sp
            report(f"mur_h_update {dist} {label} k{k} splits={count}"
                   f"{' (wrapper)' if sp is None else ''}", this_fn,
                   other_fn if sp is None else None, reps)

    def w_cases():
        """The W pass: EU at 8192^2 r128 (f32, bf16) and 8192 x 16384 r128;
        KL and lagged KL at config[1]; KL at 8192 x 4096 r128 and, for the
        rank line, at k 256 to 768."""
        print(f"MUR W pass ({card})", flush=True)
        x = torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda()
        w_case("EU 8192x8192 f32", x, 128, "eu")
        w_case("EU 8192x8192 bf16", x.bfloat16(), 128, "eu")
        del x
        x = torch.from_numpy(lowrank_dense(8192, 16384, 128, seed=0)).cuda()
        w_case("EU 8192x16384 f32", x, 128, "eu")
        del x
        x = torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()
        w_case("config[1] 20000x11000 f32", x, 50, "kl")
        w_case("config[1] 20000x11000 f32", x, 50, "kl", lagged=True)
        x = torch.from_numpy(tfidf_like(8192, 4096, n_topics=128, seed=4)).cuda()
        for k in (128, 256, 320, 384, 448, 512, 640, 768):
            w_case("KL 8192x4096 f32", x, k, "kl", reps=3 if k <= 256 else 2)
        del x
        torch.cuda.empty_cache()

    def mur_cases():
        w_cases()
        print(f"MUR passes ({card})", flush=True)
        x = torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda()
        for xx, name in ((x, "EU 8192x8192 f32"), (x.bfloat16(), "EU 8192x8192 bf16")):
            iteration_case(name, xx, 128)
            h_case(name, xx, 128, "eu", splits=(None, 1, 4, 16) if xx is x else (None,))
        del x
        # the single pass where the products bind less (k 32, 64) and more
        for m, n, k in ((8192, 32768, 32), (8192, 16384, 64), (16384, 4096, 256)):
            x = torch.from_numpy(lowrank_dense(m, n, min(k, 64), seed=0)).cuda()
            for xx, dt in ((x, "f32"), (x.bfloat16(), "bf16")):
                iteration_case(f"EU {m}x{n} {dt}", xx, k)
            del x
        x = torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()
        h_case("config[1] 20000x11000 f32", x, 50, "kl")
        x = torch.from_numpy(tfidf_like(8192, 4096, n_topics=128, seed=4)).cuda()
        for k in (128, 256, 512, 640, 768, 1024):
            h_case("KL 8192x4096 f32", x, k, "kl", reps=3 if k <= 256 else 2)
        del x
        torch.cuda.empty_cache()

    def gram_cases():
        """The Gram objective near convergence, as the card test makes it."""
        from tpunmf_torch.core.losses import eu_objective_gram

        print(f"Gram objective near convergence, error against float64 in ulps of "
              f"||X||^2 ({card})", flush=True)
        m, n, k = 2000, 1500, 64
        for seed in range(31, 37):
            rng = np.random.default_rng(seed)
            w0, h0 = rng.random((m, k)), rng.random((k, n))
            x = (w0 @ h0) * (1.0 + 1e-3 * rng.standard_normal((m, n)))
            w = w0 * (1.0 + 1e-4 * rng.standard_normal((m, k)))
            h = h0 * (1.0 + 1e-4 * rng.standard_normal((k, n)))
            x, w, h = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (x, w, h))
            xsq = torch.sum(x * x)
            ulp = float(np.spacing(np.float32(xsq.item())))
            line = f"  seed {seed}:"
            runs = {"mur_iteration_eu": (
                lambda: mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=m),
                lambda: other_iteration_eu(x, w, h)),
                "mur_h_update": (
                lambda: (w, mur_fused.mur_h_update(x, w, h, distance_type="eu", lam=0.0)[1],
                         w.T @ w),
                lambda: (w, other_h_update(x, w, h, "eu")[1], w.T @ w))}
            def err(wf, wtx, gram):  # against float64 on the same f32 W, H
                d = x.double() - wf.double() @ h.double()
                return (float(eu_objective_gram(xsq, wtx, gram, h))
                        - 0.5 * float(torch.sum(d * d))) / ulp

            for name, (mine, theirs) in runs.items():
                wf, wtx, gram = mine()
                errs = {"this": err(wf, wtx, gram), "cuBLAS": err(wf, wf.T @ x, wf.T @ wf)}
                if other is not None:
                    errs["other"] = err(*theirs())
                line += f" {name} " + ", ".join(f"{key} {v:+.2f}" for key, v in errs.items())
                line += ";"
            print(line, flush=True)

    if args.only == "gram":
        gram_cases()
        print(card)
        return 0

    # ------------------------------------------------- the two single passes
    def device_line(this_fn, other_fn, tail=""):
        """Prints the profiler's device ms of a call of each side (and
        ``tail``); returns this side's."""
        this_ms = cs.device_ms(torch, this_fn, 10)
        line = f"    device time (profiler, 10 calls): this {this_ms:.4f} ms"
        if other_fn is not None:
            line += f", other {cs.device_ms(torch, other_fn, 10):.4f} ms"
        print(line + tail, flush=True)
        return this_ms

    def kl_entry(lib_, x, w, h):
        """A call of mur_iteration_kl through the C entry of ``lib_``, its
        buffers made once: since the pair's bodies, the pair's splits and
        scratch; before, the wave plan's scratch (kind 1)."""
        m, n = x.shape
        k = w.shape[1]
        is_bf16 = int(x.dtype == torch.bfloat16)
        hsum = torch.sum(h, dim=1)
        outs = (torch.empty_like(w), torch.empty_like(h), torch.empty((), device="cuda"))
        if len(lib_.tpunmf_mur_iteration_kl.argtypes) == 14:
            scratch = torch.empty(max(lib_.tpunmf_iteration_scratch(m, n, k, x.element_size(),
                                                                      1), 1), device="cuda")
            args = (x.data_ptr(), is_bf16, w.data_ptr(), h.data_ptr(), hsum.data_ptr(), 0.0,
                    m, n, k, *(o.data_ptr() for o in outs), scratch.data_ptr(), stream())
        else:
            tc = mur_fused.kl_w_on_tensor_cores(k)
            splits = mur_fused.w_splits(m, n, k)
            ldh = mf.h_stride(n) if tc else n
            hp = torch.nn.functional.pad(h, (0, ldh - n)) if ldh != n else h
            w_floats = mur_fused.w_scratch_floats(splits, m, k)
            rows = mur_fused.h_splits(m, n, k, "kl")
            h_floats = mur_fused.h_scratch_floats(rows, n, k)
            bufs = (torch.empty(max(w_floats, 1), device="cuda"),
                    torch.empty(lib_.tpunmf_mur_w_lagged_blocks(m, k, splits), device="cuda"),
                    torch.empty(max(h_floats, 1), device="cuda"))
            scratch = (hp, *bufs)
            args = (x.data_ptr(), is_bf16, w.data_ptr(), h.data_ptr(), hp.data_ptr(), ldh,
                    hsum.data_ptr(), 0.0, m, n, k, splits, bufs[0].data_ptr(), w_floats,
                    bufs[1].data_ptr(), rows, bufs[2].data_ptr(), h_floats,
                    *(o.data_ptr() for o in outs), stream())

        def fn(keep=(hsum, scratch)):  # keep: the tensors behind args' pointers
            _build.check(lib_.tpunmf_mur_iteration_kl(*args), "mur_iteration_kl")
            return outs
        return fn

    def hals_entry(lib_, x, w, h, nsweeps):
        """A call of hals_iteration_eu through the C entry of ``lib_``, its
        buffers made once (the entries before the tensor cores took no
        scratch length)."""
        m, n = x.shape
        k = w.shape[1]
        hc, hht = h.to(x.dtype), h @ h.T
        outs = (torch.empty_like(w), torch.empty_like(h), torch.empty_like(hht))
        floats = lib_.tpunmf_iteration_scratch(m, n, k, x.element_size(), 2)
        scratch = torch.empty(max(floats, 1), device="cuda")
        head = (x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), hc.data_ptr(),
                hht.data_ptr(), 0.0, m, n, k, nsweeps)
        ptrs = tuple(o.data_ptr() for o in outs)
        args = ((*head, *ptrs, scratch.data_ptr(), stream())
                if len(lib_.tpunmf_hals_iteration_eu.argtypes) == 15 else
                (*head, *ptrs, scratch.data_ptr(), floats, stream()))

        def fn(keep=(hc, hht, scratch)):  # keep: the tensors behind args' pointers
            _build.check(lib_.tpunmf_hals_iteration_eu(*args), "hals_iteration_eu")
            return outs
        return fn

    def single_cases():
        print(f"single passes, through the C entries ({card})", flush=True)
        x = torch.from_numpy(tfidf_like(8192, 4096, n_topics=128, seed=4)).cuda()
        cases = [(f"8192x4096 {dt}", xx, 128) for xx, dt in ((x, "f32"), (x.bfloat16(), "bf16"))]
        x1 = torch.from_numpy(tfidf_like(8192, 1024, n_topics=128, seed=4)).cuda()
        cases += [("8192x1024 f32", x1, k) for k in (256, 384, 448, 512, 768, 1024)]
        for label, xx, k in cases:
            w, h = factors(*xx.shape, k, 14)
            this_fn = kl_entry(lib, xx, w, h)
            other_fn = kl_entry(other, xx, w, h) if other is not None else None
            tc = (f"W {'tensor cores' if mur_fused.kl_w_on_tensor_cores(k) else 'FMA'}, H "
                  f"{'tensor cores' if k <= mur_fused.KL_H_TC_RANK else 'FMA'}")
            report(f"mur_iteration_kl {label} k{k} ({tc})", this_fn, other_fn,
                   3 if k <= 256 else 2)
            device_line(this_fn, other_fn)
            del w, h
        del x, x1, cases
        x = torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda()
        for xx, dt, nsweeps in ((x, "f32", 2), (x, "f32", 1), (x.bfloat16(), "bf16", 2)):
            w, h = factors(8192, 8192, 128, 15)
            this_fn = hals_entry(lib, xx, w, h, nsweeps)
            other_fn = hals_entry(other, xx, w, h, nsweeps) if other is not None else None
            report(f"hals_iteration_eu 8192x8192 {dt} k128 sweeps={nsweeps}", this_fn, other_fn,
                   3)
            device_line(this_fn, other_fn)
            del w, h
        del x
        torch.cuda.empty_cache()

    def kl_cases():
        """MUR's KL passes on the tensor cores (the masked passes' bodies
        with no mask): the W pass, plain and lagged, and the H pass at
        BASELINE config[1] and 8192 x 4096 r128, and mur_iteration_kl at
        8192 x 4096 r128 through both sides' C entries."""
        print(f"MUR KL passes ({card})", flush=True)
        for label, x, k in (
                ("config[1] 20000x11000 f32",
                 torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda(), 50),
                ("KL 8192x4096 f32",
                 torch.from_numpy(tfidf_like(8192, 4096, n_topics=128, seed=4)).cuda(), 128)):
            w_case(label, x, k, "kl")
            w_case(label, x, k, "kl", lagged=True)
            h_case(label, x, k, "kl")
            if k == 128:
                w, h = factors(*x.shape, k, 14)
                this_fn = kl_entry(lib, x, w, h)
                other_fn = kl_entry(other, x, w, h) if other is not None else None
                report(f"mur_iteration_kl {label} k{k}", this_fn, other_fn, 3)
                device_line(this_fn, other_fn)
                del w, h
            del x
        torch.cuda.empty_cache()

    if args.only in ("single", "kl"):
        (single_cases if args.only == "single" else kl_cases)()
        print(card)
        return 0

    # ------------------------------------------- the EU pass on TMA and wgmma
    def tma_entry(lib_, name, x, w, h):
        """A call of mur_iteration_eu_dma (name "dma") or v1_iter ("v1")
        through the C entry of ``lib_``, its buffers made once: with the TMA
        stages H's factor operands and tpunmf_eu_tma_scratch's scratch;
        before them H in X's type (dma: the dma flag of
        tpunmf_mur_iteration_eu) or H^T (v1) and the FMA plan's (kind 0)."""
        m, n = x.shape
        k = w.shape[1]
        is_bf16 = int(x.dtype == torch.bfloat16)
        gh = h @ h.T
        outs = (torch.empty_like(w), torch.empty_like(h), torch.empty_like(gh))
        ptrs = tuple(o.data_ptr() for o in outs)
        if hasattr(lib_, "tpunmf_eu_tma_scratch"):
            f0, f1, ldh = (_launch.eu_tma_operands(x, h) if name == "dma"
                           else mur_variants.v_operands(x, h))
            floats = lib_.tpunmf_eu_tma_scratch(m, n, k, x.element_size())
            scratch = torch.empty(floats, device="cuda")
            keep = (gh, f0, f1, scratch)
            tail = (*ptrs, scratch.data_ptr(), floats, stream())
            if name == "dma":
                entry = lib_.tpunmf_mur_iteration_eu_dma
                args = (x.data_ptr(), is_bf16, w.data_ptr(), f0.data_ptr(), f1.data_ptr(), ldh,
                        gh.data_ptr(), 0.0, m, n, k, *tail)
            else:
                entry = lib_.tpunmf_v1_iter
                args = (x.data_ptr(), is_bf16, f0.data_ptr(), f1.data_ptr(), ldh, w.data_ptr(),
                        gh.data_ptr(), m, n, k, *tail)
        else:
            floats = lib_.tpunmf_iteration_scratch(m, n, k, x.element_size(), 0)
            scratch = torch.empty(max(floats, 1), device="cuda")
            if name == "dma":
                hc = h.to(x.dtype)
                entry = lib_.tpunmf_mur_iteration_eu
                args = (x.data_ptr(), is_bf16, w.data_ptr(), hc.data_ptr(), gh.data_ptr(), 0.0,
                        m, n, k, *ptrs, scratch.data_ptr(), 1, stream())
            else:
                hc = h.T.to(x.dtype).contiguous()
                entry = lib_.tpunmf_v1_iter
                args = (x.data_ptr(), is_bf16, hc.data_ptr(), w.data_ptr(), gh.data_ptr(), m,
                        n, k, *ptrs, scratch.data_ptr(), stream())
            keep = (gh, hc, scratch)

        def fn(keep=keep):  # keep: the tensors behind args' pointers
            _build.check(entry(*args), name)
            return outs
        return fn

    def dma_cases():
        print(f"the EU pass on TMA and wgmma, through the C entries ({card})", flush=True)
        for m, n, k in ((8192, 8192, 128), (8192, 16384, 128), (8192, 32768, 32),
                        (16384, 4096, 256), (8192, 8190, 128)):
            x = torch.from_numpy(lowrank_dense(m, n, min(k, 64), seed=0)).cuda()
            for xx, dt in ((x, "f32"), (x.bfloat16(), "bf16")):
                w, h = factors(m, n, k, 14)
                label = f"{m}x{n} {dt} k{k}" + (
                    "" if n * xx.element_size() % 16 == 0 else " (rows off 16 bytes)")
                for name in ("dma", "v1"):
                    this_fn = tma_entry(lib, name, xx, w, h)
                    other_fn = tma_entry(other, name, xx, w, h) if other is not None else None
                    report(f"{'mur_iteration_eu_dma' if name == 'dma' else 'v1_iter'} {label}",
                           this_fn, other_fn, 3)
                    if name == "dma":
                        device_line(this_fn, other_fn)
                auto_other = None
                if other is not None:
                    def auto_other():
                        return other_iteration_eu(xx, w, h)
                report(f"mur_iteration_eu {label}",
                       lambda: mur_fused.mur_iteration_eu(xx, w, h, lam_w=0.0, bm=m), auto_other,
                       3)
                del w, h
            del x
        torch.cuda.empty_cache()

    if args.only == "dma":
        dma_cases()
        print(card)
        return 0

    # ------------------------------------ iter_eu_int8 and the scoring kernel
    def entry_fn(entry, args, outs, keep, name):
        def fn(keep=keep):  # keep: the tensors behind args' pointers
            _build.check(entry(*args), name)
            return outs
        return fn

    def int8_entry(lib_, xq, scale, w, h):
        """iter_eu_int8 through the C entry of ``lib_``, its buffers made
        once: on the TMA stages H in bf16 and tpunmf_eu_tma_scratch's
        scratch at 1-byte X with its length; before them H in f32 and the
        FMA plan's (kind 0)."""
        m, n = xq.shape
        k = w.shape[1]
        s = torch.as_tensor(scale, dtype=torch.float32, device="cuda").reshape(())
        gh = h @ h.T
        outs = (torch.empty_like(w), torch.empty_like(h), torch.empty_like(gh))
        ptrs = tuple(o.data_ptr() for o in outs)
        head = (s.data_ptr(), m, n, k, *ptrs)
        if len(lib_.tpunmf_iter_eu_int8.argtypes) == 15:
            hb, _, ldh = _launch.eu_tma_operands(xq, h)
            floats = lib_.tpunmf_eu_tma_scratch(m, n, k, 1)
            scratch = torch.empty(floats, device="cuda")
            args = (xq.data_ptr(), hb.data_ptr(), ldh, w.data_ptr(), gh.data_ptr(), *head,
                    scratch.data_ptr(), floats, stream())
            keep = (s, gh, hb, scratch)
        else:
            floats = lib_.tpunmf_iteration_scratch(m, n, k, 1, 0)
            scratch = torch.empty(max(floats, 1), device="cuda")
            args = (xq.data_ptr(), h.data_ptr(), w.data_ptr(), gh.data_ptr(), *head,
                    scratch.data_ptr(), stream())
            keep = (s, gh, scratch)
        return entry_fn(lib_.tpunmf_iter_eu_int8, args, outs, keep, "int8")

    def int8_cases():
        print(f"iter_eu_int8, through the C entries ({card})", flush=True)
        for m, n in ((8192, 8192), (8192, 16384), (8192, 8188), (8192, 8190)):
            x = torch.from_numpy(lowrank_dense(m, n, 64, seed=0)).cuda() + 0.05
            xq, scale = sweep_int8.quantize(x)
            del x
            w, h = factors(m, n, 128, 16)
            this_fn = int8_entry(lib, xq, scale, w, h)
            other_fn = int8_entry(other, xq, scale, w, h) if other is not None else None
            path = cs.x_load_path(xq)
            report(f"iter_eu_int8 {m}x{n} k128 ({path.split(' (')[0]})", this_fn, other_fn, 3)
            device_line(this_fn, other_fn)
            if other_fn is not None:
                diff = max(cs.max_rel_err(a, b) for a, b in zip(this_fn(), other_fn()))
                print(f"    largest relative difference of the two sides' outputs {diff:.3e}",
                      flush=True)
            del xq, w, h
        torch.cuda.empty_cache()

    def score_entry(lib_, w, h, sel=128):
        """score_blockmax_relayout through the C entry of ``lib_``, its
        buffers made once: W's operands (topk_select.score_operands) on TMA
        and wgmma; before them W in f32."""
        b, r = w.shape
        n = h.shape[1]
        nbp = topk_select._blocks(n, sel)
        outs = (torch.empty((b, nbp), device="cuda"), torch.empty((b, nbp, sel), device="cuda"))
        tail = (b, r, n, nbp, sel, *(o.data_ptr() for o in outs), stream())
        hd = topk_select._H_DTYPES[h.dtype]
        if len(lib_.tpunmf_score_blockmax.argtypes) == 14:
            w0, w1, ldw, w16 = topk_select.score_operands(w, h)
            args = (w0.data_ptr(), w1.data_ptr(), ldw, h.data_ptr(), hd, int(w16), *tail)
            keep = (w0, w1)
        else:
            w32 = w.to(torch.float32).contiguous()
            args = (w32.data_ptr(), h.data_ptr(), hd, *tail)
            keep = (w32,)
        return entry_fn(lib_.tpunmf_score_blockmax, args, outs, keep, "score")

    def score_cases():
        print(f"score_blockmax_relayout, through the C entries ({card})", flush=True)
        g = torch.Generator(device="cuda")
        g.manual_seed(13)
        for b, r, n, dt in ((64, 128, 1 << 20, torch.float32), (64, 128, 1 << 20, torch.bfloat16),
                            (64, 512, 1 << 19, torch.float32), (96, 128, 40000, torch.float32),
                            (8, 64, 40001, torch.float32), (8, 64, 40001, torch.bfloat16),
                            (64, 128, (1 << 20) + 2, torch.float32)):
            w = torch.rand((b, r), generator=g, device="cuda").to(dt)
            h = torch.rand((r, n), generator=g, device="cuda").to(dt)
            this_fn = score_entry(lib, w, h)
            other_fn = score_entry(other, w, h) if other is not None else None
            label = (f"score ({b}, {r})x({r}, {n}) {'f32' if dt == torch.float32 else 'bf16'} "
                     f"({cs.x_load_path(h).split(' (')[0]})")
            report(label, this_fn, other_fn, 5)
            device_line(this_fn, other_fn)
            if other_fn is not None:
                diff = max(cs.close_err(a, b_) for a, b_ in zip(this_fn(), other_fn()))
                print(f"    largest difference of the two sides' outputs, relative to 1 + "
                      f"|score|: {diff:.3e}", flush=True)
            del w, h
        torch.cuda.empty_cache()

    # ------------------------------------------------------- the HALS sweeps
    def sweep_entry(lib_, a, g, v, nsweeps):
        """gs_sweep (lam 0) through the C entry of ``lib_``, its output made
        once (the entry's signature is the same on both sides)."""
        k, cols = v.shape
        out = torch.empty_like(v)
        args = (a.data_ptr(), *a.stride(), g.data_ptr(), v.data_ptr(), *v.stride(), 0.0, k, cols,
                nsweeps, out.data_ptr(), *out.stride(), stream())
        return entry_fn(lib_.tpunmf_gs_sweep, args, out, (a, g, v), "gs_sweep")

    def sweep_cases():
        """gs_sweep over 8192 columns in both frames at 0, 1 and 2 sweeps
        and k 37 to 1024, with its bound (roofline.sweep_flops) and the
        largest difference of the two sides' outputs (scaled as
        chip_smoke.py's SWEEP_TOL); then hals_iteration_eu at 8192^2 r128
        f32 with 2 and 1 sweeps."""
        from tpunmf_torch.ops import roofline

        print(f"HALS sweeps, through the C entries ({card})", flush=True)
        x = torch.from_numpy(lowrank_dense(8192, 8192, 64, seed=0)).cuda()
        cols = x.shape[1]
        for k in (37, 128, 264, 513, 1024):
            w, h = factors(*x.shape, k, 9)
            frames = {"W frame": ((x @ h.T).T, h @ h.T, w.T), "H frame": (w.T @ x, w.T @ w, h)}
            for frame, (a, g, v) in frames.items():
                for nsweeps in (0, 1, 2):
                    this_fn = sweep_entry(lib, a, g, v, nsweeps)
                    other_fn = (sweep_entry(other, a, g, v, nsweeps) if other is not None
                                else None)
                    report(f"gs_sweep {frame} {cols} columns k{k} sweeps={nsweeps}", this_fn,
                           other_fn, 5)
                    nbytes = 4.0 * (k * k + 3 * k * cols if nsweeps else 2 * k * cols)
                    f32, bf16, product = roofline.sweep_flops(k, cols, nsweeps)
                    bound, by = roofline.bound(f32, bf16, nbytes, product)
                    dev = device_line(this_fn, other_fn)
                    line = f"    bound {bound:.4f} ms ({by}), {bound / dev:.1%} of it on the device"
                    if other_fn is not None and nsweeps:
                        line += (f"; largest difference of the two sides, of max |out|: "
                                 f"{cs.scaled_err(this_fn(), other_fn()):.3e}")
                    print(line, flush=True)
            del w, h, frames, a, g, v
        del x
        x = torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda()
        for nsweeps in (2, 1):
            w, h = factors(8192, 8192, 128, 15)
            this_fn = hals_entry(lib, x, w, h, nsweeps)
            other_fn = hals_entry(other, x, w, h, nsweeps) if other is not None else None
            report(f"hals_iteration_eu 8192x8192 f32 k128 sweeps={nsweeps}", this_fn, other_fn, 3)
            device_line(this_fn, other_fn)
            if other_fn is not None:
                diff = max(cs.scaled_err(a, b) for a, b in zip(this_fn(), other_fn()))
                print(f"    largest difference of the two sides' outputs, of max |out|: "
                      f"{diff:.3e}", flush=True)
            del w, h
        del x
        torch.cuda.empty_cache()

    if args.only == "int8":
        int8_cases()
        print(card)
        return 0
    if args.only == "score":
        score_cases()
        print(card)
        return 0
    if args.only == "sweep":
        sweep_cases()
        print(card)
        return 0

    # ------------------------------------------------- masked H pass: the bits
    def masked_h_cases(x, mask, k=64):
        m, n = x.shape
        w, h = factors(m, n, k, 10)
        splits = mf.row_splits(m, n, k)
        part = torch.empty(2 * splits * k * n, device="cuda")
        print(f"masked_h_update, MovieLens-10M {tuple(x.shape)} k{k} uint8 mask ({card})",
              flush=True)
        for dist in ("eu", "kl"):
            def this_fn(d=dist):
                return mf.masked_h_update(x, mask, w, h, distance_type=d, lam=0.0)

            other_fn = None
            if other is not None:
                def other_fn(kl=int(dist == "kl")):
                    out = torch.empty_like(h)
                    _build.check(other.tpunmf_masked_h_update(
                        x.data_ptr(), 0, mask.data_ptr(), 1, w.data_ptr(), h.data_ptr(), 0.0,
                        m, n, k, kl, part.data_ptr(), splits, out.data_ptr(), stream()),
                        "other")
                    return out
                same = torch.equal(this_fn(), other_fn())
                bits = "the same bits as" if same else "OTHER BITS than"
                print(f"  masked_h_update {dist}: {bits} the other checkout's", flush=True)
            report(f"masked_h_update {dist} k{k} ({splits} splits)", this_fn, other_fn, 3)

    if args.only == "w":
        w_cases()
    if args.only in (None, "mur"):
        mur_cases()
    if args.only in ("mur", "w"):
        print(card)
        return 0

    # ---------------------------------------------------------- masked W pass
    def masked_w_cases(label, x, mask, ks):
        m, n = x.shape
        print(f"masked_w_update, {label} {tuple(x.shape)} uint8 mask ({card})", flush=True)
        for k, dists in ks:
            g = torch.Generator(device="cuda")
            g.manual_seed(10)
            w = torch.rand((m, k), generator=g, device="cuda") + 0.1
            h = torch.rand((k, n), generator=g, device="cuda") + 0.1
            reps = 3 if k <= 256 else 2
            for dist in dists:
                kl = int(dist == "kl")

                def this_fn(d=dist):
                    return mf.masked_w_update(x, mask, w, h, distance_type=d, lam=0.0)

                def entry(lib_, kl=kl):
                    # since the tensor-core W pass the entry takes H's row
                    # stride and the block rows
                    strided = len(lib_.tpunmf_masked_w_update.argtypes) == 15
                    out = torch.empty_like(w)
                    hp = torch.nn.functional.pad(h, (0, mf.h_stride(n) - n))
                    args = ((hp.data_ptr(), mf.h_stride(n), 0.0, m, n, k, kl,
                             mf.w_block_rows(m, k)) if strided else
                            (h.data_ptr(), 0.0, m, n, k, kl))
                    _build.check(lib_.tpunmf_masked_w_update(
                        x.data_ptr(), 0, mask.data_ptr(), 1, w.data_ptr(), *args,
                        out.data_ptr(), stream()), "masked_w_update")
                    return out

                other_fn = None
                if other is not None:
                    def other_fn():
                        return entry(other)
                    same = torch.equal(this_fn(), other_fn())
                    bits = "the same bits as" if same else "OTHER BITS than"
                    print(f"  masked_w_update k{k} {dist}: {bits} the other checkout's",
                          flush=True)
                report(f"k{k} {dist} (wrapper: {mf.w_block_rows(m, k)}-row blocks, "
                       f"stride {mf.h_stride(n)})", this_fn, other_fn, reps,
                       lambda: entry(lib))
                if k != 64:
                    continue
                want = this_fn()
                hp = torch.nn.functional.pad(h, (0, mf.h_stride(n) - n))
                for bm in (64, 32):
                    for hh, ldh, how in ((hp, mf.h_stride(n), "padded once"),
                                         (h, n, "in place")):
                        def variant(bm=bm, hh=hh, ldh=ldh, kl=kl):
                            out = torch.empty_like(w)
                            _build.check(lib.tpunmf_masked_w_update(
                                x.data_ptr(), 0, mask.data_ptr(), 1, w.data_ptr(),
                                hh.data_ptr(), ldh, 0.0, m, n, k, kl, bm, out.data_ptr(),
                                stream()), "variant")
                            return out
                        same = torch.equal(variant(), want)
                        report(f"k{k} {dist} variant: {bm}-row blocks, H {how} "
                               f"({'same bits' if same else 'other bits'})", variant, None,
                               reps)
            del w, h

    if args.only in (None, "masked"):
        if other is not None:
            mine, theirs = (sass_of(lib_._name, "masked_w_tc_kernel") for lib_ in (lib, other))
            if mine is None:
                print("masked_w_tc_kernel: no cuobjdump, machine code not compared")
            for key in sorted(mine or {}):
                a, b = mine[key], theirs.get(key)
                if b is None:
                    verdict = "not in the other checkout"
                elif a == b:
                    verdict = "the same SASS as the other checkout's"
                else:
                    ops = difflib.SequenceMatcher(None, b, a, autojunk=False).get_opcodes()
                    moved = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops
                                if tag != "equal")
                    verdict = f"OTHER SASS: {moved} lines differ from the other's {len(b)}"
                print(f"masked_w_tc_kernel {key[:40]}: {len(a) // 2} instructions, {verdict}",
                      flush=True)
        x, observed = cs.movielens_on_card(torch, *cs.ML10M, seed=3)
        masked_h_cases(x, observed.to(torch.uint8))
        masked_w_cases("MovieLens-10M", x, observed.to(torch.uint8),
                       ((64, ("eu", "kl")), (256, ("eu",)), (1024, ("eu",))))
        del x, observed
        # BASELINE config[2]'s MovieLens-1M stand-in, as chip_smoke.py makes it
        x = torch.from_numpy(movielens_like(6040, 3706, density=0.2, seed=2)).cuda()
        masked_w_cases("MovieLens-1M", x, (x > 0).to(torch.uint8), ((64, ("eu", "kl")),))
        del x
        torch.cuda.empty_cache()
    if args.only == "masked":
        print(card)
        return 0

    # -------------------------------------------------------- the objectives
    def objective_case(label, x, k, is_kl, reps=3, ratio=False):
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(12)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        fn = (fused.kl_ratio_and_obj if ratio else fused.kl_obj) if is_kl \
            else fused.eu_residual_obj
        xb = int(x.dtype == torch.bfloat16)

        other_fn = None
        if other is not None:
            parts = torch.empty(other.tpunmf_objective_blocks(m, n), device="cuda")
            out_ratio = torch.empty((m, n), device="cuda") if ratio else None

            def other_fn():
                out = torch.empty((), device="cuda")
                if ratio:
                    rc = other.tpunmf_kl_ratio_obj(
                        x.data_ptr(), xb, w.data_ptr(), h.data_ptr(), m, n, k, 1e-9,
                        out_ratio.data_ptr(), parts.data_ptr(), out.data_ptr(), stream())
                else:
                    rc = other.tpunmf_objective(
                        x.data_ptr(), xb, w.data_ptr(), h.data_ptr(), m, n, k, int(is_kl),
                        parts.data_ptr(), out.data_ptr(), stream())
                _build.check(rc, "other")
                return out
        report(f"{fn.__name__} {label} k{k}", lambda: fn(x, w, h), other_fn, reps)

    print(f"objectives ({card})", flush=True)
    x = torch.from_numpy(lowrank_dense(8192, 8192, 128, seed=0)).cuda()
    objective_case("EU 8192x8192 f32", x, 128, False)
    objective_case("EU 8192x8192 f32", x, 1536, False)
    x = torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()
    objective_case("config[1] 20000x11000 f32", x, 50, True)
    x = torch.from_numpy(tfidf_like(8192, 4096, n_topics=128, seed=4)).cuda()
    objective_case("KL 8192x4096 f32", x, 1536, True)
    del x
    torch.cuda.empty_cache()
    x, _ = cs.config3_on_card(torch)
    objective_case("config[3] 50000x20000 f32", x, 128, False)
    objective_case("config[3] 50000x20000 f32", x, 128, True, ratio=True)
    del x
    torch.cuda.empty_cache()
    objective_case("config[4] cut 50000x20000 f32", cs.config4_on_card(torch), 256, True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
