"""The operands that the kernels on TMA and wgmma take, as their wrappers
prepare them in torch.

``mur_fused.mur_iteration_eu_dma`` and the sweep scripts' ``v1_iter``,
``v2_iter`` and ``iter_eu_int8`` run csrc/wave.cuh's TmaStages, whose stage
(A) reads H as (k, ldh) arrays with 16-byte rows: at f32 X its TF32 big
and small parts (csrc/tf32x3.cuh's integer split), at bf16 and int8 X H in
bf16.  The scoring kernel of ``topk_select.score_blockmax_relayout`` reads
W (b, r) as (b, ldw) arrays with 16-byte rows: W itself where W and H are
both bf16 or both f16, else W's TF32 parts.  The kernels run only on the
card (tests/test_torch_cuda.py); the preparation is plain torch and is held
here to the split's rule, and v1's and int8's preparations to the dma
variant's, bit for bit (the card tests hold the passes to the same bits).
"""
import numpy as np
import pytest
import torch

from tpunmf_torch.ops import _launch, mur_variants, topk_select


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


@pytest.mark.parametrize("n", [1, 8, 13, 776, 777, 4096])
def test_int8_factor_operands_are_h_in_bf16(n):
    """int8 X multiplies in bf16: H rounded to bf16 as torch's .to rounds
    it, in the bf16 dma variant's layout, so that iter_eu_int8 at scale 1
    is v1_iter on xq.to(bfloat16) bit for bit."""
    k = 5
    h = _values((k, n), 4).abs()
    xq = torch.zeros((3, n), dtype=torch.int8)
    assert _launch.factor_dtype(xq) == torch.bfloat16
    f0, f1, ldh = _launch.eu_tma_operands(xq, h)
    assert ldh % 8 == 0 and n <= ldh < n + 8
    assert f0.shape == (k, ldh) and f0.dtype == torch.bfloat16 and f0.is_contiguous()
    assert f1 is f0
    assert torch.equal(f0[:, :n], h.to(torch.bfloat16))
    assert not bool((f0[:, n:] != 0).any())
    bf16 = _launch.eu_tma_operands(xq.to(torch.bfloat16), h)
    assert bf16[2] == ldh and torch.equal(bf16[0], f0)
    assert torch.equal(mur_variants.v_operands(xq.to(torch.bfloat16), h)[0], f0)


@pytest.mark.parametrize("wdtype,hdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.bfloat16)])
@pytest.mark.parametrize("r", [1, 4, 37, 128, 130])
def test_score_operands_split_exactly_with_zero_padding(r, hdtype, wdtype):
    b = 7
    w = _values((b, r), 5).abs()
    if wdtype != torch.float32:  # within the 16-bit range: no infinities
        w = torch.from_numpy(np.random.default_rng(6).random((b, r)).astype(np.float32))
    w = w.to(wdtype)
    h = torch.zeros((r, 3), dtype=hdtype)
    w0, w1, ldw, w16 = topk_select.score_operands(w, h)
    assert w16 == (wdtype == hdtype != torch.float32)
    per = 8 if w16 else 4  # 16-byte rows
    assert ldw % per == 0 and r <= ldw < r + per
    for a in (w0, w1):
        assert a.shape == (b, ldw) and a.is_contiguous()
        assert a.dtype == (wdtype if w16 else torch.float32)
        assert not bool((a[:, r:] != 0).any())  # zeros in the padding
    if w16:
        assert w1 is w0 and torch.equal(w0[:, :r], w)
        return
    big, small = _launch.tf32_split(w.to(torch.float32))
    assert torch.equal(w0[:, :r], big) and torch.equal(w1[:, :r], small)
    assert torch.equal(w0[:, :r] + w1[:, :r], w.to(torch.float32))  # exact
    if wdtype != torch.float32:  # 16-bit W is exact in TF32: no small part
        assert not bool((w1 != 0).any())
