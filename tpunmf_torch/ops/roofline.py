"""The least time an H100 could take for a kernel's work: its bound.

A kernel's bound is the larger of two times: its operations over the
card's peak rate for their type, and the bytes it must move (each input
read once, each output written once) over the memory rate.  The peaks
are those of one H100 SXM at 700 W (NVIDIA's data sheet, dense rates).
Operations come in three classes:

- f32 elementwise work (adds, comparisons) at the f32 FMA rate, 67
  TFLOP/s;
- bf16 products, on the tensor cores at 989 TFLOP/s, where both operands
  already are bf16;
- f32 products: the least time for an f32-accurate product is on the
  tensor cores as three TF32 products (big*big + big*small + small*big,
  ``csrc/tf32x3.cuh``), 495 / 3 = 165 TFLOP/s of f32 work, whichever unit
  a kernel uses, so that every bound is like for like.  The HALS sweeps'
  k^2 work a column is such a product too: blocked (``csrc/gs_panel.cuh``)
  it is all in the products of G's panels with V.

``chip_smoke.py`` computes each ported kernel's bound from the tensors of
its run.  Run as a script, this module prints the bounds of the TPU
kernels that are not ported yet, at the shapes their paths will run (every
one is ported now, and it says so):

    python -m tpunmf_torch.ops.roofline
"""
from __future__ import annotations

PEAK_F32, PEAK_BF16, PEAK_TF32, PEAK_BYTES = 67e12, 989e12, 495e12, 3.35e12
# f32 work a second in f32-accurate products: three TF32 products each
PEAK_F32_PRODUCT = PEAK_TF32 / 3


def bound(f32_flops: float, bf16_flops: float, nbytes: float,
          product_flops: float = 0.0) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time and what sets it, for
    ``f32_flops`` of elementwise f32 work, ``bf16_flops`` of bf16 products,
    ``nbytes`` moved and ``product_flops`` of f32 products."""
    ops = (f32_flops / PEAK_F32 + bf16_flops / PEAK_BF16
           + product_flops / PEAK_F32_PRODUCT)
    mem = nbytes / PEAK_BYTES
    return 1e3 * max(ops, mem), "operations" if ops >= mem else "bytes"


def mur_flops(name: str, m: int, n: int, k: int, x_bf16: bool,
              dist: str | None = None) -> tuple[float, float, float]:
    """(f32 elementwise, bf16 product, f32 product) flops of one call of a
    MUR kernel on X (m, n) at rank k.

    2 m n k is one product against X; the EU products of a bf16 X take the
    factor rounded to bf16, so both their operands are bf16, and so do
    ``iter_eu_int8``'s (int8 X widened to bf16, whatever ``x_bf16`` says).
    The k x k Grams and their products with a factor are f32 products."""
    mnk = 2.0 * m * n * k
    bf16_x = x_bf16 or name == "iter_eu_int8"
    eu_bf16, eu_f32 = (mnk, 0.0) if bf16_x else (0.0, mnk)
    grams = 2.0 * k * k * (m + n)
    if name in ("mur_iteration_eu", "mur_iteration_eu_dma", "v1_iter", "iter_eu_int8"):
        return 0.0, 2 * eu_bf16, 2 * eu_f32 + grams + 2.0 * m * k * k
    if name == "v2_iter":  # v1 with the H update folded in: Gw H
        return 0.0, 2 * eu_bf16, 2 * eu_f32 + grams + 2.0 * m * k * k + 2.0 * k * k * n
    if name == "mur_iteration_kl":
        return 0.0, 0.0, 4 * mnk
    if name in ("mur_w_update", "mur_h_update", "mur_w_update_lagged"):
        return (0.0, eu_bf16, eu_f32 + grams) if dist == "eu" else (0.0, 0.0, 2 * mnk)
    return 0.0, 0.0, mnk  # the objectives and the ratio passes: W H against X


def masked_flops(m: int, n: int, k: int) -> tuple[float, float, float]:
    """Flops of one masked half-update on X (m, n) at rank k: S = W H and
    two products against a factor, 6 m n k of f32 products."""
    return 0.0, 0.0, 6.0 * m * n * k


def sweep_flops(k: int, cols: int, nsweeps: int) -> tuple[float, float, float]:
    """(f32 elementwise, bf16 product, f32 product) flops of one
    ``gs_sweep`` call over ``cols`` columns at rank k: ``nsweeps`` sweeps
    of k steps of 2k flops a column, G[l, :] . V, all of them f32 products
    (the chain's divisions and clamps, k a column a sweep, left out)."""
    return 0.0, 0.0, 2.0 * nsweeps * cols * k * k


def hals_flops(m: int, n: int, k: int, x_bf16: bool,
               nsweeps: int) -> tuple[float, float, float]:
    """(f32 elementwise, bf16 product, f32 product) flops of one
    ``hals_iteration_eu`` call on X (m, n) at rank k: X round(H)^T and
    round(W')^T X (both-bf16 operands at bf16 X), the Grams H H^T and
    W'^T W', and ``nsweeps`` sweeps over the m rows of W
    (``sweep_flops``)."""
    mnk = 2.0 * m * n * k
    sweeps = sweep_flops(k, m, nsweeps)[2]
    grams = 2.0 * k * k * (m + n)
    return (0.0, 2 * mnk, grams + sweeps) if x_bf16 else (0.0, 0.0, 2 * mnk + grams + sweeps)


def read_probe_flops(m: int, n: int) -> tuple[float, float, float]:
    """Flops of one ``read_probe`` call on X (m, n): X + s and the sum, an
    add each per element (elementwise)."""
    return 2.0 * m * n, 0.0, 0.0


def _unported():
    """(kernel, shape, (f32, bf16, f32 product) flops, bytes) of the TPU
    kernels not ported yet, at the shapes their paths will run: none is
    left."""
    return []


def main() -> None:
    if not _unported():
        print("every TPU kernel of the repository is ported: none is left")
    for name, shape, (f32, bf16, product), nbytes in _unported():
        ms, by = bound(f32, bf16, nbytes, product)
        print(f"{name:22s} {shape:30s} {f32 / 1e9:8.2f} GFLOP f32 {bf16 / 1e9:8.2f} "
              f"GFLOP bf16 {product / 1e9:8.2f} GFLOP f32 products {nbytes / 1e6:9.1f} MB "
              f"bound {ms:.4f} ms ({by})")


if __name__ == "__main__":
    main()
