"""Work of one MUR iteration with the KL divergence and the exact
objective, counted from the shapes: X (m, n) float32, rank k.

Products (f32, TF32 off): the W update forms W H and (X / W H) H^T, the H
update W H again and W^T (X / W H), the objective W H once more: five
products of 2 m n k.  Elementwise f32 work: the two ratios (an add and a
divide an entry each), the objective's divide, log, multiply, subtract
and add, and the factors' updates.  Bytes: X read once, W and H read and
written once each, whatever a kernel reads again.
"""


def per_iteration(m: int, n: int, k: int, x_bytes: int = 4, **_) -> dict:
    mn, factors = m * n, m * k + k * n
    return {
        "product_flops": 5 * 2.0 * mn * k,
        "bf16_flops": 0.0,
        "f32_flops": 9.0 * mn + 3.0 * factors,
        "bytes": float(x_bytes * mn + 2 * 4 * factors),
    }
