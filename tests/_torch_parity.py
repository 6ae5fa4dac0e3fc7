"""Shared helpers of the tpunmf_torch parity tests.

Inputs are made with numpy from a seed and handed to both packages:
``tpunmf`` (JAX on the CPU, x64 on, see conftest.py) and ``tpunmf_torch``
(PyTorch on the CPU, float64).  Under pytest-xdist each worker keeps torch
to one thread, so parallel workers do not oversubscribe the cores.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# f64 trace agreement between the packages: the same formulas with sums
# taken in another order (XLA vs ATen); observed ~1e-14, Gram objective
# ~1e-12 (it cancels ||X||^2 against the cross term)
TRACE_RTOL = 1e-10
# f32 kernel vs plain version, as tpunmf's own kernel tests (test_ops.py)
KERNEL_RTOL = 1e-5
SUM_RTOL = 1e-4


def lowrank(seed=42, m=60, n=48, k=5, noise=0.01):
    """The conftest ``lowrank_data`` matrix (exact low rank + noise floor)."""
    rng = np.random.default_rng(seed)
    w = rng.random((m, k))
    h = rng.random((k, n))
    return (w @ h + noise * rng.random((m, n))).astype(np.float64)


def kernel_problem(seed, m=64, n=128, k=16, zeros=False):
    """f32 (x, w, h) numpy arrays at tpunmf's kernel-test shape; with
    ``zeros`` about a fifth of X is exactly 0 (the KL masking path)."""
    rng = np.random.default_rng(seed)
    x = rng.random((m, n)).astype(np.float32)
    if zeros:
        x[x < 0.2] = 0.0
    w = (rng.random((m, k)) + 0.1).astype(np.float32)
    h = (rng.random((k, n)) + 0.1).astype(np.float32)
    return x, w, h


def masked_problem(seed, m=32, n=24, k=4, frac=0.6, weights=False):
    """f32 (x, mask, w, h) numpy arrays at tpunmf's masked kernel-test shape
    (tests/test_masked.py): a fully unobserved row 3 and column 5, and
    with ``weights`` a real-valued mask in [0.5, 2) on the observed cells."""
    rng = np.random.default_rng(seed)
    x = (rng.random((m, k)) @ rng.random((k, n)) + 0.05).astype(np.float32)
    mask = (rng.random((m, n)) < frac).astype(np.float32)
    mask[3, :] = 0.0
    mask[:, 5] = 0.0
    if weights:
        mask *= (0.5 + 1.5 * rng.random((m, n))).astype(np.float32)
    w = (rng.random((m, k)) + 0.1).astype(np.float32)
    h = (rng.random((k, n)) + 0.1).astype(np.float32)
    return x, mask, w, h


def t(a):
    """numpy -> CPU tensor (a copy, so read-only JAX buffers are fine)."""
    return torch.from_numpy(np.array(a))


def assert_traces_match(got, want, rtol=TRACE_RTOL):
    """Objective traces agree iterate for iterate, NaN in the same places."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    real = ~np.isnan(want)
    np.testing.assert_allclose(got[real], want[real], rtol=rtol)


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    return torch.device("cuda")
