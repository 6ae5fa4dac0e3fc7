"""The operands that the EU pass on TMA and wgmma takes, as its wrappers
prepare them in torch.

``mur_fused.mur_iteration_eu_dma`` and the sweep scripts' ``v1_iter`` and
``v2_iter`` run csrc/wave.cuh's TmaStages, whose stage (A) reads H as
(k, ldh) arrays with 16-byte rows: at f32 X its TF32 big and small parts
(csrc/tf32x3.cuh's integer split), at bf16 X H in bf16.  The kernels run
only on the card (tests/test_torch_cuda.py); the preparation is plain
torch and is held here to the split's rule, and v1's preparation from the
pre-cast H^T to the dma variant's from H, bit for bit (the card tests hold
the two passes to the same bits at lam_w = 0).
"""
import numpy as np
import pytest
import torch

from tpunmf_torch.ops import _launch, mur_variants


def _values(shape, seed):
    """f32 values over a wide range of exponents and both signs, with zeros."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape) * np.exp2(rng.integers(-60, 60, shape))
    v[rng.random(shape) < 0.1] = 0.0
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (37, 777), (128, 1024)])
@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_is_exact_and_takes_the_integer_rule(shape, seed):
    f = _values(shape, seed)
    big, small = _launch.tf32_split(f)
    assert big.dtype == small.dtype == torch.float32
    assert torch.equal(big + small, f)  # exact: no rounding in the sum
    bits = big.view(torch.int32)
    assert not bool(((bits & 0x1FFF) != 0).any())  # 13 low mantissa bits clear
    u = f.numpy().view(np.uint32).astype(np.uint64)
    rule = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32)  # tf32x3.cuh's tc::split
    np.testing.assert_array_equal(big.numpy().view(np.uint32), rule)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 8, 13, 776, 777])
def test_eu_tma_operands_pad_rows_to_16_bytes(n, xdtype):
    k = 5
    h = _values((k, n), 2).abs()
    x = torch.zeros((3, n), dtype=xdtype)
    f0, f1, ldh = _launch.eu_tma_operands(x, h)
    assert ldh % 8 == 0 and n <= ldh < n + 8
    for f in (f0, f1):
        assert f.shape == (k, ldh) and f.dtype == xdtype and f.is_contiguous()
        assert not bool((f[:, n:] != 0).any())  # zeros in the padding
    if xdtype == torch.bfloat16:
        assert torch.equal(f0[:, :n], h.to(torch.bfloat16))
    else:
        big, small = _launch.tf32_split(h)
        assert torch.equal(f0[:, :n], big) and torch.equal(f1[:, :n], small)
        assert torch.equal(f0[:, :n] + f1[:, :n], h)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37])
@pytest.mark.parametrize("n", [8, 13, 776, 777])
def test_v1_operands_are_the_dma_variant_s_bit_for_bit(n, k, xdtype):
    h = _values((k, n), 3).abs()
    x = torch.zeros((4, n), dtype=xdtype)
    dma = _launch.eu_tma_operands(x, h)
    v1 = mur_variants.v_operands(x, h)
    assert dma[2] == v1[2]
    for a, b in zip(dma[:2], v1[:2]):
        # the kernel reads the arrays by pointer and row stride: the same
        # values in the same layout
        assert a.is_contiguous() and b.is_contiguous() and a.stride() == b.stride()
        assert torch.equal(a, b)
