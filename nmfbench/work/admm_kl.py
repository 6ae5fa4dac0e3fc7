"""Work of one ADMM iteration with the KL divergence (the data term split,
fixed rho), counted from the shapes: V (m, n) float32, rank k.

Products (f32, TF32 off): W~^T R, H~ R^T, the split's W~ H~ and the
objective's W H, four products of 2 m n k; the Grams W~^T W~ and H~ H~^T
(2 k^2 (m + n)), applying the k x k factorizations to the right-hand sides
(2 k^2 (m + n)) and the l2n prox on H (2 k^2 n).  Elementwise f32 work:
R = V~ + U_V, the closed form of V~ (eight an entry), the dual U_V (two),
and the objective (five).  Bytes: V, V~ and U_V read once, V~ and U_V
written once, the factors, their copies and duals read and written once.
"""


def per_iteration(m: int, n: int, k: int, x_bytes: int = 4, **_) -> dict:
    mn, factors = m * n, m * k + k * n
    return {
        "product_flops": 4 * 2.0 * mn * k + 4.0 * k * k * (m + n) + 2.0 * k * k * n,
        "bf16_flops": 0.0,
        "f32_flops": 16.0 * mn + 8.0 * factors,
        "bytes": float(x_bytes * mn + 4 * 4 * mn + 3 * 2 * 4 * factors),
    }
