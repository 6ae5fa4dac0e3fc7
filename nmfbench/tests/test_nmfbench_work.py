"""Work counts against hand counts at a tiny shape, the bound, and the
per-layer readers on a known context."""
import pytest

from nmfbench.harness import peaks, spec

# m, n, k = 4, 3, 2: mn = 12, mnk = 24, mk + kn = 14
HAND = {
    # five products of 2mnk; 9 elementwise an entry + 3 a factor entry;
    # X once, W and H read and written
    "mur_kl": (5 * 48, 9 * 12 + 3 * 14, 4 * 12 + 8 * 14),
    # four products, Grams and solves 4k^2(m+n), the l2n prox 2k^2 n; V, the
    # split and its dual read, the split and its dual written; three pairs
    # of factor-sized arrays read and written
    "admm_kl": (4 * 48 + 16 * 7 + 8 * 3, 16 * 12 + 8 * 14, 4 * 12 + 16 * 12 + 24 * 14),
}


@pytest.mark.parametrize("method", sorted(HAND))
def test_hand_counts(method):
    work = spec.load_module("work", method).per_iteration(4, 3, 2)
    product, f32, nbytes = HAND[method]
    assert work["product_flops"] == pytest.approx(product)
    assert work["f32_flops"] == pytest.approx(f32)
    assert work["bytes"] == pytest.approx(nbytes)
    assert work["bf16_flops"] == 0.0


def test_bound_takes_the_larger_side():
    ops = {"product_flops": 165e12, "f32_flops": 67e12, "bf16_flops": 0.0, "bytes": 3.35e12}
    assert peaks.bound_s(ops) == pytest.approx(2.0)
    assert peaks.bound_by(ops) == "operations"
    mem = dict(ops, bytes=3 * 3.35e12)
    assert peaks.bound_s(mem) == pytest.approx(3.0)
    assert peaks.bound_by(mem) == "bytes"


def test_readers():
    work = {"product_flops": 495e9, "bf16_flops": 0.0, "f32_flops": 0.0, "bytes": 0.0}
    ctx = {"busy_s": 1.5, "window_s": 2.0, "iterations": 100, "kernels": 450, "syncs": 101,
           "work": work, "bound_s": 0.006}
    read = {n: spec.load_module("metrics", n).read(ctx)
            for n in ("device_idle", "step_roofline", "step_mfu", "launches_per_iter",
                      "syncs_per_iter")}
    assert read["device_idle"] == pytest.approx(25.0)
    assert read["step_roofline"] == pytest.approx(40.0)
    assert read["step_mfu"] == pytest.approx(5.0)
    assert read["launches_per_iter"] == pytest.approx(4.5)
    assert read["syncs_per_iter"] == pytest.approx(1.01)
    empty = dict(ctx, busy_s=0.0, window_s=0.0, iterations=0)
    assert all(spec.load_module("metrics", n).read(empty) is None for n in read)
