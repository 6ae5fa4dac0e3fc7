"""tpunmf_torch ops: plain versions vs tpunmf's Pallas kernels (interpret
mode on the CPU), the wrappers' dispatch and checks, and the kernel build.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
compares them with their plain versions there.
"""
import ctypes
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import KERNEL_RTOL, SUM_RTOL, kernel_problem, t
from tpunmf.core import losses as jlosses
from tpunmf.ops import fused as jfused
from tpunmf.ops import mur_fused as jmur_fused
from tpunmf.ops import topk_select as jselect
from tpunmf_torch.core import losses as tlosses
from tpunmf_torch.ops import _build, _launch
from tpunmf_torch.ops import fused as tfused
from tpunmf_torch.ops import mur_fused as tmur_fused
from tpunmf_torch.ops import topk_select as tselect

DIST_LAM = [(d, lam) for d in ("eu", "kl") for lam in (0.0, 0.2)]


def _jax_w_update(x, w, h, dist, lam):
    xj = jnp.asarray(x)
    bm, bn = jmur_fused.mur_tileable(xj, w.shape[1])
    return np.asarray(jmur_fused.mur_w_update(
        xj, jnp.asarray(w), jnp.asarray(h), distance_type=dist, lam=lam,
        bm=bm, bn=bn, interpret=True))


def _jax_h_update(x, w, h, dist, lam):
    xj = jnp.asarray(x)
    bm, bn = jmur_fused.mur_tileable(xj, w.shape[1])
    h_new, numer = jmur_fused.mur_h_update(
        xj, jnp.asarray(w), jnp.asarray(h), distance_type=dist, lam=lam,
        bm=bm, bn=bn, interpret=True)
    return np.asarray(h_new), np.asarray(numer)


@pytest.mark.parametrize("dist,lam", DIST_LAM)
def test_w_update_matches_pallas_kernel(dist, lam):
    x, w, h = kernel_problem(1, zeros=dist == "kl")
    want = _jax_w_update(x, w, h, dist, lam)
    got = tmur_fused.mur_w_update(t(x), t(w), t(h), distance_type=dist, lam=lam)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_RTOL)


@pytest.mark.parametrize("dist,lam", DIST_LAM)
def test_h_update_matches_pallas_kernel(dist, lam):
    x, w, h = kernel_problem(2, zeros=dist == "kl")
    want_h, want_numer = _jax_h_update(x, w, h, dist, lam)
    got_h, got_numer = tmur_fused.mur_h_update(t(x), t(w), t(h),
                                               distance_type=dist, lam=lam)
    np.testing.assert_allclose(got_numer.numpy(), want_numer, rtol=KERNEL_RTOL)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=KERNEL_RTOL)


@pytest.mark.parametrize("which", ["w", "h"])
def test_eu_updates_round_the_factor_like_the_kernel_for_bf16_x(which):
    """bf16 X: the EU kernels cast the factor to bf16 before the product
    (mur_fused.py:84, :716); the plain versions round the same operands."""
    x, w, h = kernel_problem(3)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    xt16 = t(x).to(torch.bfloat16)
    if which == "w":
        bm, bn = jmur_fused.mur_tileable(x16, 16)
        want = np.asarray(jmur_fused.mur_w_update(
            x16, jnp.asarray(w), jnp.asarray(h), distance_type="eu", lam=0.0,
            bm=bm, bn=bn, interpret=True))
        got = tmur_fused.mur_w_update(xt16, t(w), t(h), distance_type="eu",
                                      lam=0.0).numpy()
    else:
        bm, bn = jmur_fused.mur_tileable(x16, 16)
        want = np.asarray(jmur_fused.mur_h_update(
            x16, jnp.asarray(w), jnp.asarray(h), distance_type="eu", lam=0.0,
            bm=bm, bn=bn, interpret=True)[1])
        got = tmur_fused.mur_h_update(xt16, t(w), t(h), distance_type="eu",
                                      lam=0.0)[1].numpy()
        # the rounding matters: the unrounded W gives another numerator
        unrounded = (t(w).T @ xt16.float()).numpy()
        assert not np.allclose(got, unrounded, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=KERNEL_RTOL)


@pytest.mark.parametrize("lam", [0.0, 0.2])
def test_lagged_w_update_matches_pallas_kernel(lam):
    """The W pass with the lagged objective: the new W, and the masked KL
    of the incoming (w, h) (tpunmf/ops/mur_fused.py:114-141)."""
    x, w, h = kernel_problem(18, zeros=True)
    xj = jnp.asarray(x)
    bm, bn = jmur_fused.mur_tileable(xj, w.shape[1])
    want_w, want_obj = jmur_fused.mur_w_update(
        xj, jnp.asarray(w), jnp.asarray(h), distance_type="kl", lam=lam, bm=bm,
        bn=bn, with_lagged_obj=True, interpret=True)
    before = (tmur_fused.mur_w_update.launches, tmur_fused.mur_w_update.lagged_launches)
    got_w, got_obj = tmur_fused.mur_w_update(t(x), t(w), t(h), distance_type="kl",
                                             lam=lam, with_lagged_obj=True)
    assert (tmur_fused.mur_w_update.launches,
            tmur_fused.mur_w_update.lagged_launches) == before
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=KERNEL_RTOL)
    assert got_obj.dim() == 0 and np.isfinite(float(got_obj))
    np.testing.assert_allclose(float(got_obj), float(want_obj), rtol=SUM_RTOL)
    assert torch.equal(got_w, tmur_fused.mur_w_update(t(x), t(w), t(h),
                                                      distance_type="kl", lam=lam))
    assert torch.equal(got_obj, tfused.kl_obj(t(x), t(w), t(h)))


def test_lagged_objective_is_a_kl_only_mode():
    x, w, h = (t(a) for a in kernel_problem(19))
    for fn in (tmur_fused.mur_w_update, tmur_fused.mur_w_update_ref):
        with pytest.raises(ValueError, match="KL-only"):
            fn(x, w, h, distance_type="eu", lam=0.0, with_lagged_obj=True)


def test_eu_obj_matches_pallas_kernel():
    x, w, h = kernel_problem(4)
    xj, wj, hj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(h)
    want = float(jfused._eu_obj_pallas(xj, wj, hj, *jfused._tileable(xj, wj, hj),
                                       interpret=True))
    got = tfused.eu_residual_obj(t(x), t(w), t(h))
    np.testing.assert_allclose(float(got), want, rtol=SUM_RTOL)


def test_kl_obj_matches_pallas_kernel_with_zeros():
    x, w, h = kernel_problem(5, zeros=True)
    assert (x == 0).mean() > 0.1
    xj, wj, hj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(h)
    want = float(jfused._kl_obj_pallas(xj, wj, hj, *jfused._tileable(xj, wj, hj),
                                       interpret=True))
    got = tfused.kl_obj(t(x), t(w), t(h))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), want, rtol=SUM_RTOL)


def test_kl_masking_order_matches_tpunmf():
    """+inf (x > 0, wh == 0) is zeroed before NaN (x == 0); -x + wh is
    summed for every cell, masked or not; the log has no eps."""
    x = np.array([[0.0, 1.0, 2.0], [0.5, 0.0, 3.0]])
    wh = np.array([[0.3, 0.0, 1.0], [0.0, 0.0, 2.0]])
    want = float(jlosses.kl_elementwise_sum(jnp.asarray(x), jnp.asarray(wh)))
    got = float(tlosses.kl_elementwise_sum(t(x), t(wh)))
    # masked cells contribute only wh - x
    by_hand = (2 * np.log(2.0) - 2 + 1) + (3 * np.log(1.5) - 3 + 2) \
        + (0.3 - 0) + (0 - 1) + (0 - 0.5) + 0.0
    assert got == want
    np.testing.assert_allclose(got, by_hand, rtol=1e-14)


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_objective_plain_versions_match_tpunmf_at_f64(dist):
    x, w, h = (a.astype(np.float64) for a in kernel_problem(6, zeros=True))
    jfn = jfused.eu_residual_obj if dist == "eu" else jfused.kl_obj
    tfn = tfused.eu_residual_obj if dist == "eu" else tfused.kl_obj
    want = float(jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h)))
    got = tfn(t(x), t(w), t(h))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-13)


def test_kl_ratio_and_obj_match_tpunmf_at_f64():
    x, w, h = (a.astype(np.float64) for a in kernel_problem(7, zeros=True))
    jr, jo = jfused.kl_ratio_and_obj(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h))
    tr, to = tfused.kl_ratio_and_obj(t(x), t(w), t(h))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-14)
    np.testing.assert_allclose(float(to), float(jo), rtol=1e-13)
    want = np.asarray(jfused.kl_ratio(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h)))
    for fn in (tfused.kl_ratio, tfused.kl_ratio_ref):
        got = fn(t(x), t(w), t(h))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_kl_ratio_matches_pallas_kernel_with_zeros(xdtype):
    """X / (W H + eps) as an f32 m x n array, the eps in the denominator
    (exact zeros in X give exact zeros); bf16 X is widened to f32."""
    x, w, h = kernel_problem(24, zeros=True)
    assert (x == 0).mean() > 0.1
    xj, wj, hj = jnp.asarray(x).astype(getattr(jnp, xdtype)), jnp.asarray(w), jnp.asarray(h)
    # tpunmf's _tileable refuses bf16 X (it then takes its jnp step); the
    # kernel body runs on it all the same, at f32's tile
    tile = jfused._tileable(jnp.asarray(x), wj, hj)
    want = np.asarray(jfused._kl_ratio_pallas(xj, wj, hj, 1e-9, *tile, interpret=True))
    xt = t(x).to(getattr(torch, xdtype))
    before = tfused.kl_ratio.launches
    for fn in (tfused.kl_ratio, tfused.kl_ratio_ref):
        got = fn(xt, t(w), t(h))
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        assert torch.equal(got == 0, xt == 0)
    assert tfused.kl_ratio.launches == before  # CPU: the plain version
    # the same ratio as kl_ratio_and_obj's
    assert torch.equal(tfused.kl_ratio(xt, t(w), t(h)), tfused.kl_ratio_and_obj(xt, t(w), t(h))[0])


def test_kl_ratio_and_obj_matches_pallas_kernel_with_zeros():
    """The ratio takes the eps, the KL term the raw product (exact zeros
    in X exercise the masking)."""
    x, w, h = kernel_problem(15, zeros=True)
    assert (x == 0).mean() > 0.1
    xj, wj, hj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(h)
    want_r, want_o = jfused._kl_ratio_obj_pallas(
        xj, wj, hj, 1e-9, *jfused._tileable(xj, wj, hj), interpret=True)
    for fn in (tfused.kl_ratio_and_obj, tfused.kl_ratio_and_obj_ref):
        got_r, got_o = fn(t(x), t(w), t(h))
        assert got_r.dtype == torch.float32 and got_r.shape == x.shape
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-6)
        np.testing.assert_allclose(float(got_o), float(want_o), rtol=1e-5)


# tests/test_serve.py:373-376's shapes: one tile, a ragged tail, an odd
# batch over two tiles, bfloat16
BLOCKMAX_SHAPES = [(4, 16384, "float32"), (4, 40000, "float32"),
                   (3, 16384 * 2, "float32"), (8, 20000, "bfloat16")]


@pytest.mark.parametrize("b,n,dtype", BLOCKMAX_SHAPES)
def test_blockmax_relayout_matches_pallas_kernel_bit_for_bit(b, n, dtype):
    rng = np.random.default_rng(b * n)
    s = rng.standard_normal((b, n)).astype(np.float32)
    s[b - 1, n // 3] = np.nan  # propagates into its block's maximum
    sj = jnp.asarray(s).astype(getattr(jnp, dtype))
    want_m, want_s3 = jselect.blockmax_relayout(sj, interpret=True)
    got_m, got_s3 = tselect.blockmax_relayout(t(s).to(getattr(torch, dtype)))
    assert got_m.dtype == got_s3.dtype == getattr(torch, dtype)
    assert got_s3.shape == want_s3.shape and got_s3.shape[1] % 128 == 0
    np.testing.assert_array_equal(got_m.float().numpy(), np.asarray(want_m, np.float32))
    np.testing.assert_array_equal(got_s3.float().numpy(), np.asarray(want_s3, np.float32))
    assert torch.isnan(got_m[b - 1]).sum() == 1
    lo = torch.finfo(got_s3.dtype).min
    assert bool((got_s3.reshape(b, -1)[:, n:] == lo).all())


@pytest.mark.parametrize("b,n,dtype,sel_block",
                         [(b, n, dtype, 128) for b, n, dtype in BLOCKMAX_SHAPES]
                         + [(2, 32768, "float32", 256), (4, 16384, "float32", 256)])
def test_blockmax_relayout_s3_is_a_view_exactly_where_the_blocks_tile_n(b, n, dtype,
                                                                        sel_block):
    """nbp * sel_block == n: s3 shares the scores' storage; elsewhere it is
    a fresh tensor padded with finfo.min.  Both against the Pallas kernel."""
    rng = np.random.default_rng(b * n + sel_block)
    s = rng.standard_normal((b, n)).astype(np.float32)
    want_m, want_s3 = jselect.blockmax_relayout(jnp.asarray(s).astype(getattr(jnp, dtype)),
                                                sel_block=sel_block, interpret=True)
    scores = t(s).to(getattr(torch, dtype))
    got_m, got_s3 = tselect.blockmax_relayout(scores, sel_block)
    np.testing.assert_array_equal(got_m.float().numpy(), np.asarray(want_m, np.float32))
    np.testing.assert_array_equal(got_s3.float().numpy(), np.asarray(want_s3, np.float32))
    nbp = got_s3.shape[1]
    shares = got_s3.untyped_storage().data_ptr() == scores.untyped_storage().data_ptr()
    assert shares == (nbp * sel_block == n)
    if not shares:
        assert bool((got_s3.reshape(b, -1)[:, n:] == torch.finfo(got_s3.dtype).min).all())


# tests/test_serve.py:447-450's shapes: ragged n, bfloat16 inputs, two
# row tiles
SCORE_SHAPES = [(8, 128, 16384, "float32"), (8, 128, 40000, "float32"),
                (8, 64, 16384, "bfloat16"), (96, 128, 16384, "float32")]


@pytest.mark.parametrize("b,r,n,dtype", SCORE_SHAPES)
def test_score_blockmax_relayout_matches_pallas_kernel(b, r, n, dtype):
    rng = np.random.default_rng(b * r + n)
    w = rng.random((b, r)).astype(np.float32)
    h = rng.random((r, n)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_m, want_s3 = jselect.score_blockmax_relayout(
        jnp.asarray(w).astype(jd), jnp.asarray(h).astype(jd), interpret=True)
    got_m, got_s3 = tselect.score_blockmax_relayout(t(w).to(td), t(h).to(td))
    assert got_m.dtype == got_s3.dtype == torch.float32
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_s3.numpy(), np.asarray(want_s3), rtol=2e-5, atol=2e-5)


def test_serving_wrappers_on_the_cpu_take_their_plain_versions():
    rng = np.random.default_rng(16)
    s = t(rng.standard_normal((3, 500)).astype(np.float32))
    w, h = t(rng.random((3, 8)).astype(np.float32)), t(rng.random((8, 500)).astype(np.float32))
    before = (tselect.blockmax_relayout.launches, tselect.score_blockmax_relayout.launches,
              tfused.kl_ratio_and_obj.launches)
    for a, b in zip(tselect.blockmax_relayout(s), tselect.blockmax_relayout_ref(s)):
        assert torch.equal(a, b)
    for a, b in zip(tselect.score_blockmax_relayout(w, h),
                    tselect.score_blockmax_relayout_ref(w, h)):
        assert torch.equal(a, b)
    assert (tselect.blockmax_relayout.launches, tselect.score_blockmax_relayout.launches,
            tfused.kl_ratio_and_obj.launches) == before
    meta = torch.empty((4, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tselect.blockmax_relayout(meta)
    with pytest.raises(ValueError, match="multiple of 128"):
        tselect.blockmax_relayout(s, sel_block=100)


def test_gram_objective_matches_tpunmf():
    x, w, h = (a.astype(np.float64) for a in kernel_problem(8))
    xsq, wtx, gw = (x * x).sum(), w.T @ x, w.T @ w
    want = float(jlosses.eu_objective_gram(xsq, jnp.asarray(wtx), jnp.asarray(gw),
                                           jnp.asarray(h)))
    got = float(tlosses.eu_objective_gram(torch.tensor(xsq), t(wtx), t(gw), t(h)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, 0.5 * ((x - w @ h) ** 2).sum(), rtol=1e-10)


# the H pass's row splits (ops/mur_fused.py: h_splits): EU 128 x 128 tiles
# of (k, n) near 4 blocks a SM, KL 64 x 64 near 16, whole 64-row tiles of X
@pytest.mark.parametrize("m,n,k,dist,splits", [
    (8192, 8192, 128, "eu", 8), (8192, 16384, 128, "eu", 4), (8192, 8192, 1024, "eu", 1),
    (20000, 11000, 50, "kl", 12), (8192, 4096, 128, "kl", 16), (8192, 4096, 512, "kl", 4),
    (8192, 4096, 640, "kl", 3), (8192, 4096, 641, "kl", 1), (300, 777, 37, "eu", 5),
    (300, 777, 37, "kl", 5), (64, 48, 5, "eu", 1), (1000, 777, 1024, "kl", 1),
    (100000, 200000, 1024, "eu", 1)])
def test_h_splits_cut_whole_tiles_from_the_shape(m, n, k, dist, splits):
    """The count depends on the shape alone; every row of X is in exactly
    one split (masked_fused.split_ranges is the same cut), none empty, and
    the partial sums stay within 1 GiB (100000 x 200000 at k 1024 would
    want more than one split of 819 MB).  Above KL_H_TC_RANK (640) the KL
    pass runs its FMA body, which takes no splits."""
    from tpunmf_torch.ops import masked_fused as tmasked

    got = tmur_fused.h_splits(m, n, k, dist)
    assert got == splits
    ranges = tmasked.split_ranges(m, got)
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    assert all(a < b and a % tmasked.H_TILE == 0 for a, b in ranges)
    assert sum(b - a for a, b in ranges) == m
    assert 4 * tmur_fused.h_scratch_floats(got, n, k) <= 1 << 30


@pytest.mark.parametrize("splits,want", [(1, 0), (2, 2 * 37 * 777), (12, 12 * 37 * 777)])
def test_h_scratch_is_a_partial_sum_a_split(splits, want):
    """One split sums into the numerator itself: no scratch."""
    assert tmur_fused.h_scratch_floats(splits, 777, 37) == want


@pytest.mark.parametrize("k,tensor_cores", [
    (1, True), (50, True), (tmur_fused.KL_W_TC_RANK, True),
    (tmur_fused.KL_W_TC_RANK + 1, False), (1024, False)])
def test_kl_w_pass_takes_the_tensor_cores_up_to_its_rank_line(k, tensor_cores):
    """The KL W pass (plain and lagged) runs on the tensor cores up to
    KL_W_TC_RANK and its FMA body above; the line is the rank alone, within
    the update kernels' bound, and a CPU call takes the plain version on
    either side of it."""
    assert tmur_fused.kl_w_on_tensor_cores(k) is tensor_cores
    assert tmur_fused.KL_W_TC_RANK < _launch.MAX_RANK
    x, w, h = (t(a) for a in kernel_problem(20, m=9, n=7, k=k, zeros=True))
    kw = dict(distance_type="kl", lam=0.1, with_lagged_obj=True)
    got = tmur_fused.mur_w_update(x, w, h, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, tmur_fused.mur_w_update_ref(x, w, h,
                                                                                  **kw)))


# the KL W pass's column splits (ops/mur_fused.py: w_splits): 64-row tiles
# x 64-wide chunks of k near 16 blocks a SM, whole 64-column tiles of X
@pytest.mark.parametrize("m,n,k,splits", [
    (20000, 11000, 50, 7), (8192, 4096, 128, 8), (8192, 4096, 256, 4), (300, 777, 37, 13),
    (17000, 77, 37, 2), (130, 70, 1, 2), (8192, 4096, tmur_fused.KL_W_TC_RANK + 1, 1),
    (100000, 20000, 64, 1)])
def test_w_splits_cut_whole_column_tiles_from_the_shape(m, n, k, splits):
    """The count depends on the shape alone, none empty, the partial sums
    within 1 GiB; above KL_W_TC_RANK the FMA body takes no splits, and one
    split needs no scratch."""
    got = tmur_fused.w_splits(m, n, k)
    assert got == splits
    tiles = -(-n // 64)
    per = -(-tiles // got)
    assert (got - 1) * per < tiles <= got * per
    assert 4 * tmur_fused.w_scratch_floats(got, m, k) <= 1 << 30
    assert tmur_fused.w_scratch_floats(got, m, k) == (got * m * k if got > 1 else 0)


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_h_update_splits_on_cpu_take_the_plain_version(dist):
    """On a CPU tensor splits= changes nothing: the plain version runs,
    bit for bit, and no launch is counted."""
    x, w, h = (t(a) for a in kernel_problem(19, zeros=dist == "kl"))
    before = tmur_fused.mur_h_update.launches
    want = tmur_fused.mur_h_update_ref(x, w, h, distance_type=dist, lam=0.1)
    for splits in (None, 1, 3, 7):
        got = tmur_fused.mur_h_update(x, w, h, distance_type=dist, lam=0.1, splits=splits)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tmur_fused.mur_h_update.launches == before


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    x, w, h = kernel_problem(9)
    wrappers = (tmur_fused.mur_w_update, tmur_fused.mur_h_update,
                tfused.eu_residual_obj, tfused.kl_obj, tfused.kl_ratio)
    before = [fn.launches for fn in wrappers]
    got = tmur_fused.mur_w_update(t(x), t(w), t(h), distance_type="kl", lam=0.1)
    want = tmur_fused.mur_w_update_ref(t(x), t(w), t(h), distance_type="kl", lam=0.1)
    assert torch.equal(got, want)
    tmur_fused.mur_h_update(t(x), t(w), t(h), distance_type="eu", lam=0.0)
    tfused.eu_residual_obj(t(x), t(w), t(h))
    tfused.kl_obj(t(x), t(w), t(h))
    assert torch.equal(tfused.kl_ratio(t(x), t(w), t(h)), tfused.kl_ratio_ref(t(x), t(w), t(h)))
    assert [fn.launches for fn in wrappers] == before


def test_wrappers_refuse_other_devices_and_unknown_distances():
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.kl_obj(meta, meta, meta)
    x, w, h = kernel_problem(10)
    with pytest.raises(KeyError):
        tmur_fused.mur_w_update(t(x), t(w), t(h), distance_type="is", lam=0.0)


@pytest.mark.parametrize("bad", ["x_f64", "w_bf16", "chain", "rank", "strided"])
def test_check_operands_rejects(bad):
    x, w, h = (t(a) for a in kernel_problem(11, m=8, n=12, k=3))
    if bad == "x_f64":
        x = x.double()
    elif bad == "w_bf16":
        w = w.to(torch.bfloat16)
    elif bad == "chain":
        h = h[:, :-1]
    elif bad == "rank":
        w, h = torch.ones((8, 1025)), torch.ones((1025, 12))
    else:
        x = torch.ones((12, 8)).T
    with pytest.raises((TypeError, ValueError)):
        _launch.check_operands("k", x, w, h, max_rank=1024)
    good = [t(a) for a in kernel_problem(11, m=8, n=12, k=3)]
    assert _launch.check_operands("k", *good, max_rank=1024) == (8, 12, 3)
    if bad == "rank":  # each family passes its own bound: the objectives 2048
        assert _launch.check_operands("k", good[0], w, h, max_rank=2048) == (8, 12, 1025)
        with pytest.raises(ValueError, match=r"k=2049 outside \[1, 2048\]"):
            _launch.check_operands("k", good[0], torch.ones((8, 2049)),
                                   torch.ones((2049, 12)), max_rank=2048)


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = _build._digest()
    assert before == _build._digest()
    src = csrc / "objective.cu"
    src.write_text(src.read_text() + "\n// changed\n")
    assert _build._digest() != before


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.library.__wrapped__()
    assert not list((tmp_path / "build").glob("*.so"))


def test_c_signatures_pass_pointers_as_void_p():
    for name, argtypes in _build._SIGNATURES.items():
        assert name.startswith("tpunmf_")
        assert all(a in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float)
                   for a in argtypes)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _build.check(2, "tpunmf_objective")


def _c_prototypes():
    """{name: (result type, [parameter declarations])} of the extern "C"
    entries of ops/csrc."""
    protos = {}
    for src in sorted(_build._CSRC.glob("*.cu")):
        for ret, name, params in re.findall(r"^(int|long long) (tpunmf_\w+)\(([^)]*)\)\s*\{",
                                            src.read_text(), re.M):
            protos[name] = (ret, [p.strip() for p in params.split(",")])
    return protos


def _ctype(decl):
    if "*" in decl:
        return ctypes.c_void_p
    for prefix, ctype in (("long long", ctypes.c_longlong), ("int", ctypes.c_int),
                          ("float", ctypes.c_float)):
        if decl.startswith(prefix):
            return ctype
    raise ValueError(decl)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_signatures_follow_the_c_prototypes(name):
    """Each ctypes signature is its C entry's, parameter by parameter and
    in its result: a 64-bit length (the W pass's scratch, which passes
    INT_MAX floats near m * k = 1e9) crosses as c_longlong, and every C
    entry has a signature."""
    protos = _c_prototypes()
    assert sorted(protos) == sorted(_build._SIGNATURES)
    ret, params = protos[name]
    assert _build._SIGNATURES[name] == tuple(_ctype(p) for p in params)
    assert _build._RESULTS.get(name, ctypes.c_int) == _ctype(ret)
