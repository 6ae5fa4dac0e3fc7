#!/usr/bin/env python3
"""Time the masked W pass and the objective passes on one CUDA card, alone
and in turns with the same kernels of another checkout.

    python3 tools/kernel_turns.py [--parent DIR]

DIR is a checkout of another commit (for instance the parent, unpacked
with ``git archive`` into a git-ignored directory); its kernels are built
from its own ``tpunmf_torch/ops/csrc`` and called through its own C
entries.  Each case prints the ms of one call (CUDA events, the mean of
``reps`` calls back to back after a warm-up call, host launch path
included, as chip_smoke.py times a kernel alone), and with DIR the other
checkout's ms in turns (other, this, this, other) and their ratio, on the
card named by nvidia-smi.

Cases, on chip_smoke.py's data recipes:
  - masked_w_update at MovieLens-10M's shape (69878 x 10677, 1.34%
    observed, uint8 mask): EU and KL at k 64; EU at k 256 and 1024; and at
    MovieLens-1M's (6040 x 3706, 20% observed) EU and KL at k 64.  At k 64
    also the variants of this checkout's kernel through its C entry: 64-
    and 32-row blocks, H in place (4-byte copies, as n % 4 != 0) and
    through a padded copy made once;
  - eu_residual_obj at 8192 x 8192 r128 and r1536 and at BASELINE
    config[3] (50000 x 20000 r128); kl_obj at config[1] (20000 x 11000
    r50) and 8192 x 4096 r1536.
Needs the card; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose kernels to time in turns")
    args = ap.parse_args()

    import chip_smoke as cs
    from tpunmf_torch.data import lowrank_dense, movielens_like, tfidf_like
    from tpunmf_torch.ops import _build, fused
    from tpunmf_torch.ops import masked_fused as mf

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    lib = _build.library()
    other = other_library(args.parent) if args.parent else None

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def report(label, this_fn, other_fn, reps):
        ms = cs.time_pair(torch, this_fn, this_fn, reps)[0]
        line = f"  {label:44s} this {ms:9.4f} ms"
        if other_fn is not None:
            this_ms, other_ms = cs.time_pair(torch, other_fn, this_fn, reps)
            line += (f"   in turns: this {this_ms:9.4f} ms, other {other_ms:9.4f} ms, "
                     f"other / this {other_ms / this_ms:.3f}")
        print(line, flush=True)

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

                other_fn = None
                if other is not None:
                    def other_fn(kl=kl):
                        out = torch.empty_like(w)
                        _build.check(other.tpunmf_masked_w_update(
                            x.data_ptr(), 0, mask.data_ptr(), 1, w.data_ptr(), h.data_ptr(),
                            0.0, m, n, k, kl, out.data_ptr(), stream()), "other")
                        return out
                report(f"k{k} {dist} (wrapper: {mf.w_block_rows(m, k)}-row blocks, "
                       f"stride {mf.h_stride(n)})", this_fn, other_fn, reps)
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

    x, observed = cs.movielens_on_card(torch, *cs.ML10M, seed=3)
    masked_w_cases("MovieLens-10M", x, observed.to(torch.uint8),
                   ((64, ("eu", "kl")), (256, ("eu",)), (1024, ("eu",))))
    del x, observed
    # BASELINE config[2]'s MovieLens-1M stand-in, as chip_smoke.py makes it
    x = torch.from_numpy(movielens_like(6040, 3706, density=0.2, seed=2)).cuda()
    masked_w_cases("MovieLens-1M", x, (x > 0).to(torch.uint8), ((64, ("eu", "kl")),))
    del x
    torch.cuda.empty_cache()

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
