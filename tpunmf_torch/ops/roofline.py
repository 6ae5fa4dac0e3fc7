"""The least time an H100 could take for a kernel's work: its bound.

A kernel's bound is the larger of two times: its operations over the
card's peak rate for their type, and the bytes it must move (each input
read once, each output written once) over the memory rate.  The peaks
are those of one H100 SXM at 700 W (NVIDIA's data sheet, dense rates):
f32 outside the tensor cores, and bf16 on the tensor cores, which a
product may use only where both its operands already are bf16.

``chip_smoke.py`` computes each ported kernel's bound from the tensors of
its run.  Run as a script, this module prints the bounds of the TPU
kernels that are not ported yet, at the shapes their paths will run (every
one is ported now, and it says so):

    python -m tpunmf_torch.ops.roofline
"""
from __future__ import annotations

PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12


def bound(f32_flops: float, bf16_flops: float, nbytes: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time and what sets it."""
    ops = f32_flops / PEAK_F32 + bf16_flops / PEAK_BF16
    mem = nbytes / PEAK_BYTES
    return 1e3 * max(ops, mem), "operations" if ops >= mem else "bytes"


def mur_flops(name: str, m: int, n: int, k: int, x_bf16: bool,
              dist: str | None = None) -> tuple[float, float]:
    """(f32, bf16) flops of one call of a MUR kernel on X (m, n) at rank k.

    2 m n k is one product against X; the EU products of a bf16 X take the
    factor rounded to bf16, so both their operands are bf16, and so do
    ``iter_eu_int8``'s (int8 X widened to bf16, whatever ``x_bf16`` says).
    The k x k Grams and their products with a factor are f32."""
    mnk = 2.0 * m * n * k
    eu_x = (0.0, mnk) if x_bf16 or name == "iter_eu_int8" else (mnk, 0.0)
    grams = 2.0 * k * k * (m + n)
    if name in ("mur_iteration_eu", "mur_iteration_eu_dma", "v1_iter", "iter_eu_int8"):
        return 2 * eu_x[0] + grams + 2.0 * m * k * k, 2 * eu_x[1]
    if name == "v2_iter":  # v1 with the H update folded in: Gw H
        return 2 * eu_x[0] + grams + 2.0 * m * k * k + 2.0 * k * k * n, 2 * eu_x[1]
    if name == "mur_iteration_kl":
        return 4 * mnk, 0.0
    if name in ("mur_w_update", "mur_h_update", "mur_w_update_lagged"):
        return (eu_x[0] + grams, eu_x[1]) if dist == "eu" else (2 * mnk, 0.0)
    return mnk, 0.0  # the objectives and kl_ratio: W H against X


def hals_flops(m: int, n: int, k: int, x_bf16: bool, nsweeps: int) -> tuple[float, float]:
    """(f32, bf16) flops of one ``hals_iteration_eu`` call on X (m, n) at
    rank k: X round(H)^T and round(W')^T X (both-bf16 operands at bf16 X),
    the Grams H H^T and W'^T W', and ``nsweeps`` sweeps of k steps of 2k
    flops a row of W."""
    mnk = 2.0 * m * n * k
    sweeps = 2.0 * nsweeps * m * k * k
    grams = 2.0 * k * k * (m + n)
    return (grams + sweeps, 2 * mnk) if x_bf16 else (2 * mnk + grams + sweeps, 0.0)


def read_probe_flops(m: int, n: int) -> tuple[float, float]:
    """(f32, bf16) flops of one ``read_probe`` call on X (m, n): X + s and
    the sum, an add each per element."""
    return 2.0 * m * n, 0.0


def _unported():
    """(kernel, shape, f32 flops, bf16 flops, bytes) of the TPU kernels
    not ported yet, at the shapes their paths will run: none is left."""
    return []


def main() -> None:
    if not _unported():
        print("every TPU kernel of the repository is ported: none is left")
    for name, shape, f32_flops, bf16_flops, nbytes in _unported():
        ms, by = bound(f32_flops, bf16_flops, nbytes)
        print(f"{name:22s} {shape:30s} {f32_flops / 1e9:8.2f} GFLOP f32 "
              f"{bf16_flops / 1e9:8.2f} GFLOP bf16 {nbytes / 1e6:9.1f} MB "
              f"bound {ms:.4f} ms ({by})")


if __name__ == "__main__":
    main()
