"""The single-pass EU iteration's variants on the card: v1 (H^T pre-cast to
X's dtype), v2 (the H update folded in), and a tensor-core probe.

The counterpart of ``tpunmf``'s benchmarks/sweep_iter2.py, run on a CUDA
card:

    python -m tpunmf_torch.sweeps.sweep_iter2 [--seed 0]

It checks one v1 iteration against the plain formula, times the v1 loop
(and the v2 loop) at the script's strip heights bm, and times a chain of
bf16 products (the script's MXU probe; here ``torch.matmul`` on the
tensor cores, a library product outside any kernel of the port).

The data follow the script's recipe and shapes, 8192 x 8192 at rank 128:
W0, H0 ~ U[0, 1) and X = bf16(W0 H0), drawn from a seeded
``torch.Generator`` on the card.  ``jax.random``'s draws cannot be
reproduced in torch, so the matrices are not the script's own.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..core.precision import full_f32
from ..ops.mur_variants import v1_iter, v2_iter
from . import bench, card_line

EPS = 1e-9
M = N = 8192
K = 128
BMS = (128, 256, 512)  # the script's strip heights (sweep_iter2.py:176)


def make_v1(bm):
    """The script's v1 loop (sweep_iter2.py:133-143): ``iters`` v1 passes,
    each followed by the H update in torch (outside the Pallas body there
    too); returns sum(W[0]) + sum(H[:, 0]).  No host read inside."""
    @full_f32()
    def run(x, w, h, iters):
        for _ in range(iters):
            w, wtx, gw = v1_iter(x, w, h, bm)
            h = h * wtx / (gw @ h + EPS)
        return torch.sum(w[0]) + torch.sum(h[:, 0])
    return run


def make_v2(bm):
    """The script's v2 loop (sweep_iter2.py:146-155): ``iters`` v2 passes,
    the H update inside them; returns sum(W[0]) + sum(H[:, 0])."""
    def run(x, w, h, iters):
        for _ in range(iters):
            w, h, _, _ = v2_iter(x, w, h, bm)
        return torch.sum(w[0]) + torch.sum(h[:, 0])
    return run


@full_f32()
def problem(seed: int, m: int = M, n: int = N, k: int = K, device="cuda"):
    """(X bf16 (m, n), W0 (m, k), H0 (k, n)): the script's recipe
    (sweep_iter2.py:161-167) from a seeded torch generator."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    w0 = torch.rand((m, k), generator=g, device=device)
    h0 = torch.rand((k, n), generator=g, device=device)
    return (w0 @ h0).to(torch.bfloat16), w0, h0


@full_f32()
def v1_check(x, w0, h0):
    """max |W' - W'_plain| / max W'_plain of one v1 pass at bm = 128 against
    the script's plain formula, X and H unrounded (sweep_iter2.py:169-174)."""
    w1, _, _ = v1_iter(x, w0, h0, 128)
    xf = x.float()
    wr = w0 * (xf @ h0.T) / (w0 @ (h0 @ h0.T) + EPS)
    return float(torch.max(torch.abs(w1 - wr)) / torch.max(wr))


def mxu_probe(seed: int, iters: int = 10, device="cuda"):
    """(seconds, TFLOP/s) of one 2048 x 65536 x 2048 bf16 product in the
    script's chain c = c/2 + (a b)/2 (sweep_iter2.py:183-199): the card's
    tensor-core rate through ``torch.matmul``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    a = torch.rand((2048, 65536), generator=g, device=device).to(torch.bfloat16)
    b = torch.rand((65536, 2048), generator=g, device=device).to(torch.bfloat16)

    def chain(count):
        c = torch.zeros((2048, 2048), device=device)
        for _ in range(count):
            c = 0.5 * c + 0.5 * (a @ b).float()
        return float(torch.sum(c[0]))

    chain(2)
    t0 = time.perf_counter()
    chain(iters)
    t = (time.perf_counter() - t0) / iters
    return t, 2 * 2048 * 65536 * 2048 / t / 1e12


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_iter2: needs a CUDA card", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    x, w0, h0 = problem(args.seed)
    print(f"v1 w rel err vs plain formula: {v1_check(x, w0, h0):.3e}", flush=True)
    print(f"{M}x{N} r{K} bf16 X; the card's tiling ignores bm (it is checked "
          "against m, as the script's grid would use it)", flush=True)
    for bm in BMS:
        t = bench(make_v1(bm), x, w0, h0)
        print(f"v1 bm={bm}: {t * 1e3:.3f} ms  {1 / t:.1f} it/s", flush=True)
    t = bench(make_v2(BMS[0]), x, w0, h0)
    print(f"v2 bm={BMS[0]}: {t * 1e3:.3f} ms  {1 / t:.1f} it/s", flush=True)
    t, tflops = mxu_probe(args.seed)
    print(f"tensor-core probe (2048x65536x2048 bf16, torch.matmul): {t * 1e3:.2f} ms -> "
          f"{tflops:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
