#!/usr/bin/env python3
"""Time the MUR passes, the masked passes and the objective passes on one
CUDA card, alone and in turns with the same kernels of another checkout.

    python3 tools/kernel_turns.py [--parent DIR] [--only mur|w|masked|objectives|gram]

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
    r50) and 8192 x 4096 r1536.
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
    ap.add_argument("--only", choices=("mur", "w", "masked", "objectives", "gram"),
                    help="time one family of cases (w: the MUR W pass alone, a part of "
                         "mur; gram: accuracy, no times)")
    args = ap.parse_args()

    import chip_smoke as cs
    from tpunmf_torch.data import lowrank_dense, movielens_like, tfidf_like
    from tpunmf_torch.ops import _build, fused
    from tpunmf_torch.ops import masked_fused as mf
    from tpunmf_torch.ops import mur_fused

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
        _build.check(other.tpunmf_mur_iteration_eu(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), hc.data_ptr(),
            gh.data_ptr(), 0.0, m, n, k, *(o.data_ptr() for o in outs), scratch.data_ptr(), 0,
            stream()), "other")
        return outs

    def other_h_update(x, w, h, dist):
        """The other checkout's mur_h_update, as its wrapper calls it (one
        split where it takes splits)."""
        m, n = x.shape
        k = w.shape[1]
        is_kl = int(dist == "kl")
        aux = torch.sum(w, dim=0) if is_kl else w.T @ w
        h_out, numer = torch.empty_like(h), torch.empty_like(h)
        extra = ((numer.data_ptr(), 1) if len(other.tpunmf_mur_h_update.argtypes) == 15
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
            def other_fn():
                return other_h_update(x, w, h, dist)
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
    def objective_case(label, x, k, is_kl, reps=3):
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(12)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        fn = fused.kl_obj if is_kl else fused.eu_residual_obj

        other_fn = None
        if other is not None:
            parts = torch.empty(other.tpunmf_objective_blocks(m, n), device="cuda")

            def other_fn():
                out = torch.empty((), device="cuda")
                _build.check(other.tpunmf_objective(
                    x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), h.data_ptr(),
                    m, n, k, int(is_kl), parts.data_ptr(), out.data_ptr(), stream()), "other")
                return out
        report(f"{'kl_obj' if is_kl else 'eu_residual_obj'} {label} k{k}",
               lambda: fn(x, w, h), other_fn, reps)

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
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
