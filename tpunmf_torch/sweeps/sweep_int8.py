"""The single-pass EU iteration on int8-quantised X, on the card.

The counterpart of ``tpunmf``'s benchmarks/sweep_int8.py, run on a CUDA
card:

    python -m tpunmf_torch.sweeps.sweep_int8 [--seed 0]

X is stored as int8 with a symmetric per-matrix scale s = max|X| / 127;
the kernel widens it to bf16 (exactly) and the factors stay f32.  It
times the int8 loop at the script's strip heights and prints the
quantisation's effect on the objective after 30 iterations against the
f32 single-pass loop (``tpunmf``'s route rule and ``mur_iteration_eu``)
from the same init.

The data follow the script's recipe and shapes, 8192 x 8192 at rank 128:
W0, H0 ~ U[0, 1) and X = W0 H0 + 0.05, drawn from a seeded
``torch.Generator`` on the card.  ``jax.random``'s draws cannot be
reproduced in torch, so the matrices are not the script's own.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..core.precision import full_f32
from ..ops.mur_fused import iter_eu_tileable, mur_iteration_eu
from ..ops.mur_variants import iter_eu_int8
from . import bench, card_line

EPS = 1e-9
M = N = 8192
K = 128
BMS = (128, 256)  # the script's strip heights (sweep_int8.py:106)
ITERS = 30


def quantize(x):
    """(xq int8, scale 0-d f32): the script's symmetric per-matrix
    quantisation (sweep_int8.py:101-103), X ~ scale * xq."""
    scale = torch.max(torch.abs(x)) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def make_run(bm):
    """The script's int8 loop (sweep_int8.py:78-89): ``iters`` int8 passes,
    each followed by the H update in torch; returns (W, H, sum(W[0]) +
    sum(H[:, 0])).  No host read inside."""
    @full_f32()
    def run(xq, scale, w, h, iters):
        for _ in range(iters):
            w, wtx, gw = iter_eu_int8(xq, scale, w, h, bm)
            h = h * wtx / (gw @ h + EPS)
        return w, h, torch.sum(w[0]) + torch.sum(h[:, 0])
    return run


@full_f32()
def run_f32(x, w, h, iters):
    """The script's f32 reference loop (sweep_int8.py:123-132): ``iters``
    passes of ``mur_iteration_eu`` at lam_w = 0 with the strip height of
    ``tpunmf``'s rule, each followed by the H update; returns (W, H)."""
    bm = iter_eu_tileable(x, w.shape[1])
    if bm is None:
        raise ValueError(f"tpunmf's rule sends {tuple(x.shape)} {x.dtype} at k={w.shape[1]} "
                         "to no single pass")
    for _ in range(iters):
        w, wtx, gw = mur_iteration_eu(x, w, h, lam_w=0.0, bm=bm)
        h = h * wtx / (gw @ h + EPS)
    return w, h


@full_f32()
def objective(x, w, h) -> float:
    """½‖X − W H‖², as the script's accuracy line computes it."""
    return float(0.5 * torch.sum((x - w @ h) ** 2))


@full_f32()
def problem(seed: int, m: int = M, n: int = N, k: int = K, device="cuda"):
    """(X f32 (m, n), W0, H0): the script's recipe (sweep_int8.py:95-101)
    from a seeded torch generator."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    w0 = torch.rand((m, k), generator=g, device=device)
    h0 = torch.rand((k, n), generator=g, device=device)
    return w0 @ h0 + 0.05, w0, h0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_int8: needs a CUDA card", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    x, w0, h0 = problem(args.seed)
    xq, scale = quantize(x)
    print(f"{M}x{N} r{K} int8 X, scale {float(scale):.6e}; the card's tiling ignores bm "
          "(it is checked against m, as the script's grid would use it)", flush=True)
    for bm in BMS:
        t = bench(make_run(bm), xq, scale, w0, h0, iters=ITERS)
        print(f"int8 single-pass bm={bm}: {t * 1e3:.3f} ms/iter ({1 / t:.1f} it/s)",
              flush=True)
    wq, hq, _ = make_run(BMS[0])(xq, scale, w0, h0, ITERS)
    obj_q = objective(x, wq, hq)
    wf, hf = run_f32(x, w0, h0, ITERS)
    obj_f = objective(x, wf, hf)
    print(f"objective after {ITERS} iters: int8 {obj_q:.6e} vs f32 {obj_f:.6e} "
          f"(rel dev {(obj_q - obj_f) / obj_f:+.3%})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
