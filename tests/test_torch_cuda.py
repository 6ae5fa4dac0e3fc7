"""tpunmf_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere.  The file imports
neither JAX nor tpunmf, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

import tpunmf_torch
from _torch_parity import (cuda_device, kernel_problem, lowrank,  # noqa: F401
                           masked_problem, t)
from tpunmf_torch.ops import (_build, fused, hals_sweep, masked_fused, mur_fused,
                              mur_variants, read_probe, topk_select)
from tpunmf_torch.serve import topk
from tpunmf_torch.solvers import cuda_defaults
from tpunmf_torch.solvers.mur import mur_route
from tpunmf_torch.sweeps import sweep_int8, sweep_iter2

# f32 sums of positive terms in another order (see chip_smoke.py)
RTOL = 1e-4
# two kernels of one function whose sums come in another order (the tensor
# cores' against FMA tiles): f32 X as RTOL; at bf16 X the order can move the
# rounding of W' to bf16 by one bf16 ulp (2^-8) in a term of wtx
ROUTE_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}
# the Gram objective near convergence: the kernels against cuBLAS's f32
# products, in units in the last place of ||X||^2 (on an H100 with the
# sums that feed it rounded at every step: within 1.0; with the tensor
# cores' own sums 4-13 off)
GRAM_ULPS = 2


def _on(device, xdtype, m=1000, n=777, k=37):
    x, w, h = (t(a).to(device) for a in kernel_problem(12, m=m, n=n, k=k, zeros=True))
    return x.to(xdtype), w, h


def _pairs(got, want):
    return zip(got if isinstance(got, tuple) else (got,),
               want if isinstance(want, tuple) else (want,))


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("lam", [0.0, 0.2])
@pytest.mark.parametrize("which", ["w", "h"])
def test_updates_match_plain_versions(cuda_device, which, lam, dist, xdtype):
    x, w, h = _on(cuda_device, xdtype)
    fn = mur_fused.mur_w_update if which == "w" else mur_fused.mur_h_update
    ref = mur_fused.mur_w_update_ref if which == "w" else mur_fused.mur_h_update_ref
    before = fn.launches
    got = fn(x, w, h, distance_type=dist, lam=lam)
    assert fn.launches == before + 1
    for a, b in _pairs(got, ref(x, w, h, distance_type=dist, lam=lam)):
        assert a.dtype == torch.float32 and a.is_cuda
        torch.testing.assert_close(a, b, rtol=RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_objectives_match_plain_versions(cuda_device, dist, xdtype):
    x, w, h = _on(cuda_device, xdtype)
    fn = fused.kl_obj if dist == "kl" else fused.eu_residual_obj
    ref = fused.kl_obj_ref if dist == "kl" else fused.eu_residual_obj_ref
    got = fn(x, w, h)
    assert torch.isfinite(got)
    torch.testing.assert_close(got, ref(x, w, h), rtol=RTOL, atol=0)
    # partials are added in a fixed order: the same inputs give the same bits
    assert torch.equal(fn(x, w, h), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [70, 71])
@pytest.mark.parametrize("k", [1, 37, 64, 65, 130, 513, mur_fused.KL_W_TC_RANK,
                               mur_fused.KL_W_TC_RANK + 1, 1024])
def test_kl_updates_cover_the_rank_range(cuda_device, k, n):
    """k = 513..1024 takes the halved KL blocks (kWideRank in mur_update.cu)
    of the FMA bodies; the W pass runs on the tensor cores up to
    KL_W_TC_RANK (one 64-wide chunk of k a block: k 65 and 130 end in a
    short chunk) and its FMA body above.  m = 130 is ragged; H's rows are
    padded to 16 bytes for the tensor cores (n % 4 != 0).  The lagged W
    pass gives the plain W bit for bit and the objective of the incoming
    (W, H)."""
    x, w, h = _on(cuda_device, torch.float32, m=130, n=n, k=k)
    for fn, ref in ((mur_fused.mur_w_update, mur_fused.mur_w_update_ref),
                    (mur_fused.mur_h_update, mur_fused.mur_h_update_ref)):
        for a, b in _pairs(fn(x, w, h, distance_type="kl", lam=0.1),
                           ref(x, w, h, distance_type="kl", lam=0.1)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
    got_w, got_obj = mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=0.1,
                                            with_lagged_obj=True)
    assert torch.equal(got_w, mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=0.1))
    torch.testing.assert_close(got_obj, fused.kl_obj_ref(x, w, h), rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda_device):
    x, w, h = _on(cuda_device, torch.float32)
    with pytest.raises(TypeError):
        mur_fused.mur_w_update(x.double(), w, h, distance_type="eu", lam=0.0)
    with pytest.raises(ValueError):
        fused.kl_obj(x.T.contiguous().T, w, h)  # non-contiguous view
    with pytest.raises(ValueError):
        fused.kl_obj(x, w.cpu(), h)


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_fused_route_matches_plain_route(cuda_device, dist):
    x = t(lowrank()).float().to(cuda_device)
    kw = dict(method="mur", distance_type=dist, min_iter=20, max_iter=20,
              nndsvd_init=(True, "mean"))
    fused_run = tpunmf_torch.NMF(x, 5).factorize(**kw)
    plain_run = tpunmf_torch.NMF(x, 5).factorize(use_pallas=False, **kw)
    assert fused_run.i == plain_run.i == 19
    np.testing.assert_allclose(fused_run.obj_history, plain_run.obj_history, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lam", [0.0, 0.2])
@pytest.mark.parametrize("k", [37, 600])
def test_lagged_w_pass_matches_plain_version(cuda_device, k, lam, xdtype):
    x, w, h = _on(cuda_device, xdtype, m=300, n=277, k=k)
    before = (mur_fused.mur_w_update.launches, mur_fused.mur_w_update.lagged_launches)
    got_w, got_obj = mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=lam,
                                            with_lagged_obj=True)
    assert (mur_fused.mur_w_update.launches,
            mur_fused.mur_w_update.lagged_launches) == (before[0], before[1] + 1)
    want_w, want_obj = mur_fused.mur_w_update_ref(x, w, h, distance_type="kl", lam=lam,
                                                  with_lagged_obj=True)
    torch.testing.assert_close(got_w, want_w, rtol=RTOL, atol=0)
    torch.testing.assert_close(got_obj, fused.kl_obj_ref(x, w, h), rtol=RTOL, atol=0)
    torch.testing.assert_close(got_obj, want_obj, rtol=RTOL, atol=0)
    # the same W as the obj-free kernel, and a bit-reproducible objective
    assert torch.equal(got_w, mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=lam))
    assert torch.equal(mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=lam,
                                              with_lagged_obj=True)[1], got_obj)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(17000, 77, 37), (2000, 777, 130), (300, 277, 130),
                                   (300, 277, mur_fused.KL_W_TC_RANK),
                                   (300, 277, mur_fused.KL_W_TC_RANK + 1), (300, 277, 600)])
def test_lagged_objective_counts_each_cell_once(cuda_device, m, n, k):
    """On the tensor cores every 64-wide chunk of k forms the same S; only
    the first chunk's blocks add the objective, one partial a 64-row tile
    and column split.  A chunk (or a split) counted twice would double
    part of the objective; above KL_W_TC_RANK the FMA body writes one
    partial a block of 64 rows, 32 above k 512 (kWideRank)."""
    x, w, h = _on(cuda_device, torch.float32, m=m, n=n, k=k)
    want_obj = fused.kl_obj_ref(x, w, h)
    want_w = mur_fused.mur_w_update_ref(x, w, h, distance_type="kl", lam=0.0)
    splits = mur_fused.w_splits(m, n, k)
    for sp in {None, 1, 2, splits}:
        got_w, got_obj = mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=0.0,
                                                with_lagged_obj=True, splits=sp)
        torch.testing.assert_close(got_obj, want_obj, rtol=RTOL, atol=0)
        torch.testing.assert_close(got_w, want_w, rtol=RTOL, atol=0)
    lib = _build.library()
    fma_rows = 64 if k <= 512 else 32
    want_blocks = (-(-m // 64) * splits if k <= mur_fused.KL_W_TC_RANK
                   else -(-m // fma_rows))
    assert lib.tpunmf_mur_w_lagged_blocks(m, k, splits) == want_blocks


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 130])
@pytest.mark.parametrize("n", [776, 777])  # rows of H on 16 bytes, or padded
def test_kl_w_update_over_column_splits(cuda_device, n, k, xdtype):
    """m = 300 (the last 64-row tile short): the KL W pass over 1 split,
    2, 5, 13 (one a 64-column tile) and 20 (more than the tiles: the last
    splits empty) and the default count, lam 0 and 0.2.  Each within RTOL
    of the plain version, one launch a call, the same bits on a second
    call with the same splits, and the lagged pass's W its bit for bit."""
    x, w, h = _on(cuda_device, xdtype, m=300, n=n, k=k)
    for lam in (0.0, 0.2):
        kw = dict(distance_type="kl", lam=lam)
        want = mur_fused.mur_w_update_ref(x, w, h, **kw)
        for splits in (1, 2, 5, 13, 20, None):
            before = mur_fused.mur_w_update.launches
            got = mur_fused.mur_w_update(x, w, h, splits=splits, **kw)
            assert mur_fused.mur_w_update.launches == before + 1
            assert got.dtype == torch.float32 and torch.isfinite(got).all()
            torch.testing.assert_close(got, want, rtol=RTOL, atol=0)
            assert torch.equal(mur_fused.mur_w_update(x, w, h, splits=splits, **kw), got)
            lagged = mur_fused.mur_w_update(x, w, h, splits=splits, with_lagged_obj=True, **kw)
            assert torch.equal(lagged[0], got)
    with pytest.raises(ValueError, match="splits=0"):
        mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=0.0, splits=0)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lam", [0.0, 0.2])
@pytest.mark.parametrize("m,n,k", [(1000, 777, 37), (1000, 776, 130)])
def test_eu_w_pass_is_the_single_pass_w_bit_for_bit(cuda_device, m, n, k, lam, xdtype):
    """The EU W pass is mur_iteration_eu's W side on the same plan (stage
    (A) on the tensor cores over the same column chunks, the same
    fixed-order sum and update): the same W' bits, within RTOL of the
    plain version, one launch a call."""
    x, w, h = _on(cuda_device, xdtype, m=m, n=n, k=k)
    before = mur_fused.mur_w_update.launches
    got = mur_fused.mur_w_update(x, w, h, distance_type="eu", lam=lam)
    assert mur_fused.mur_w_update.launches == before + 1
    assert torch.equal(got, mur_fused.mur_iteration_eu(x, w, h, lam_w=lam, bm=m)[0])
    torch.testing.assert_close(got, mur_fused.mur_w_update_ref(x, w, h, distance_type="eu",
                                                               lam=lam), rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_eu_w_pass_refuses_a_short_scratch(cuda_device):
    """The C entry checks the wrapper's scratch against its own plan:
    tpunmf_mur_w_eu_scratch's length is exactly what it needs."""
    x, w, h = _on(cuda_device, torch.float32, m=1000, n=777, k=37)
    m, n, k = 1000, 777, 37
    lib = _build.library()
    floats = lib.tpunmf_mur_w_eu_scratch(m, n, k, 4)
    scratch = torch.empty(floats, device=cuda_device)
    out = torch.empty_like(w)
    gh = h @ h.T
    stream = torch.cuda.current_stream().cuda_stream
    for length, status in ((floats, 0), (floats - 1, 1)):  # 1: cudaErrorInvalidValue
        assert lib.tpunmf_mur_w_update(x.data_ptr(), 0, w.data_ptr(), h.data_ptr(), n,
                                       gh.data_ptr(), 0.0, m, n, k, 0, 1,
                                       scratch.data_ptr(), length, out.data_ptr(),
                                       stream) == status
    torch.testing.assert_close(out, mur_fused.mur_w_update_ref(x, w, h, distance_type="eu",
                                                               lam=0.0), rtol=RTOL, atol=0)


# the EU W pass's scratch (csrc/mur_update.cu: tpunmf_mur_w_eu_scratch):
# one partial a column chunk of the tensor-core plan (rows rounded up to
# 128), then m x k for W Gh, counted in 64 bits
@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,chunks,rows", [
    (8192, 8192, 128, 4, 8192),      # 64 blocks: 4 chunks of 2048 columns
    (8192, 16384, 128, 4, 8192),     # 4 chunks of 4096
    (1000, 777, 37, 13, 1024),       # 8 blocks: 33 wanted, 13 tiles of 64 columns
    (20000, 11000, 1024, 1, 20096),  # 1256 blocks fill the card alone
    (64, 48, 5, 1, 128),             # one tile
    (2**21 + 1, 64, 1024, 1, 2**21 + 128)])  # past INT_MAX floats
def test_eu_w_scratch_holds_the_plan_s_partials_and_den(cuda_device, m, n, k, chunks, rows):
    lib = _build.library()
    for x_bytes in (4, 2):  # the tensor-core plan takes all of X at either type
        assert lib.tpunmf_mur_w_eu_scratch(m, n, k, x_bytes) == chunks * rows * k + m * k


def _sweep_problem(device, frame, cols, k, seed=13):
    rng = np.random.default_rng(seed)
    other = 50
    f = t(rng.random((cols, k)).astype(np.float32) + 0.1).to(device)
    g_src = t(rng.random((k, other)).astype(np.float32)).to(device)
    x = t(rng.random((cols, other)).astype(np.float32)).to(device)
    g = g_src @ g_src.T
    if frame == "w":  # (X H^T)^T and W^T: transposed views of row-major tensors
        return (x @ g_src.T).T, g, f.T
    return (x @ g_src.T).T.contiguous(), g, f.T.contiguous()


def _scaled_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["w", "h"])
@pytest.mark.parametrize("lam", [0.0, 0.3])
@pytest.mark.parametrize("nsweeps", [1, 2])
@pytest.mark.parametrize("k", [1, 37, 128, 513, 1024])
def test_gs_sweep_matches_plain_version(cuda_device, k, nsweeps, lam, frame):
    a, g, v = _sweep_problem(cuda_device, frame, 1000 if k < 500 else 70, k)
    assert v.is_contiguous() == (frame == "h" or k == 1)
    before = hals_sweep.gs_sweep.launches
    got = hals_sweep.gs_sweep(a, g, v, lam=lam, nsweeps=nsweeps)
    assert hals_sweep.gs_sweep.launches == before + 1
    assert got.stride() == v.stride()
    want = hals_sweep.gs_sweep_ref(a, g, v, lam=lam, nsweeps=nsweeps)
    assert torch.isfinite(got).all() and (got >= 0).all()
    assert _scaled_err(got, want) <= RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("lam", [0.0, 0.2])
@pytest.mark.parametrize("mask_kind", ["uint8", "bool", "weights"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["w", "h"])
def test_masked_updates_match_plain_versions(cuda_device, which, xdtype, mask_kind,
                                             lam, dist):
    x, mask, w, h = (t(a).to(cuda_device) for a in masked_problem(
        14, m=300, n=277, k=37, weights=mask_kind == "weights"))
    x = x.to(xdtype)
    mask = {"uint8": mask.to(torch.uint8), "bool": mask.bool(),
            "weights": mask.to(xdtype)}[mask_kind]
    fn = masked_fused.masked_w_update if which == "w" else masked_fused.masked_h_update
    ref = (masked_fused.masked_w_update_ref if which == "w"
           else masked_fused.masked_h_update_ref)
    before = fn.launches
    got = fn(x, mask, w, h, distance_type=dist, lam=lam)
    assert fn.launches == before + 1
    want = ref(x, mask, w, h, distance_type=dist, lam=lam)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0)
    if dist == "kl":  # the cold row and column keep their entries
        cold = (slice(3, 4), slice(None)) if which == "w" else (slice(None), slice(5, 6))
        old = w if which == "w" else h
        assert torch.equal(got[cold], old[cold])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 64, 257, 513, 1024])
def test_masked_updates_cover_the_rank_range(cuda_device, k):
    """Both passes: k above 64 takes more 64-wide chunks of k (a grid axis
    of the W pass, 64-row chunks of the H pass), each forming S again over
    all of k; the H pass gives the same bits on a second call."""
    x, mask, w, h = (t(a).to(cuda_device) for a in masked_problem(15, m=130, n=70, k=k))
    for dist in ("eu", "kl"):
        for fn, ref in ((masked_fused.masked_w_update, masked_fused.masked_w_update_ref),
                        (masked_fused.masked_h_update, masked_fused.masked_h_update_ref)):
            got = fn(x, mask.to(torch.uint8), w, h, distance_type=dist, lam=0.1)
            torch.testing.assert_close(
                got, ref(x, mask, w, h, distance_type=dist, lam=0.1), rtol=RTOL, atol=0)
        assert torch.equal(masked_fused.masked_h_update(x, mask.to(torch.uint8), w, h,
                                                        distance_type=dist, lam=0.1), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(6040, 3706, 64), (6040, 3706, 256), (4500, 260, 256),
                                   (300, 277, 37)])
def test_masked_w_update_gives_the_same_bits_on_a_second_call(cuda_device, m, n, k):
    """The W pass at MovieLens-1M's shape (6040 x 3706: 32-row blocks at k
    64, 64-row blocks at k 256; n % 4 == 2, so H is read through its padded
    copy), at n % 4 == 0 (H read in place) and at a ragged one (m % 64 and
    n % 4 != 0): within RTOL of its plain version, and bit for bit the same
    on a second call, with no partial sums."""
    x, mask, w, h = (t(a).to(cuda_device) for a in masked_problem(19, m=m, n=n, k=k))
    mask = mask.to(torch.uint8)
    for dist in ("eu", "kl"):
        kw = dict(distance_type=dist, lam=0.2)
        got = masked_fused.masked_w_update(x, mask, w, h, **kw)
        torch.testing.assert_close(got, masked_fused.masked_w_update_ref(x, mask, w, h, **kw),
                                   rtol=RTOL, atol=0)
        assert torch.equal(masked_fused.masked_w_update(x, mask, w, h, **kw), got)
        if dist == "kl":  # the cold row keeps its entries
            assert torch.equal(got[3], w[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("m,n,k", [(300, 277, 37), (1000, 260, 64)])
def test_masked_h_update_over_row_splits(cuda_device, m, n, k, splits, dist):
    """The H pass over 1, 2, 3 (an uneven last split: 300 rows are 5 tiles
    of 64) and 7 row splits (more splits than tiles: empty splits add
    zeros) against its plain version, at ragged shapes (n % 4 == 0 and not);
    the cold column keeps its entries under KL, and a second call gives
    the same bits."""
    x, mask, w, h = (t(a).to(cuda_device) for a in masked_problem(18, m=m, n=n, k=k))
    mask = mask.to(torch.uint8)
    kw = dict(distance_type=dist, lam=0.2)
    before = masked_fused.masked_h_update.launches
    got = masked_fused.masked_h_update(x, mask, w, h, splits=splits, **kw)
    assert masked_fused.masked_h_update.launches == before + 1
    torch.testing.assert_close(got, masked_fused.masked_h_update_ref(x, mask, w, h, **kw),
                               rtol=RTOL, atol=0)
    if dist == "kl":
        assert torch.equal(got[:, 5], h[:, 5])
    assert torch.equal(masked_fused.masked_h_update(x, mask, w, h, splits=splits, **kw), got)
    with pytest.raises(ValueError):
        masked_fused.masked_h_update(x, mask, w, h, splits=0, **kw)


@pytest.mark.cuda
def test_new_wrappers_raise_instead_of_falling_back(cuda_device):
    x, mask, w, h = (t(a).to(cuda_device) for a in masked_problem(16))
    with pytest.raises(TypeError):  # a mask of another float type than x
        masked_fused.masked_w_update(x, mask.double(), w, h, distance_type="eu", lam=0.0)
    with pytest.raises(ValueError):
        masked_fused.masked_h_update(x, mask.T.contiguous().T, w, h, distance_type="kl",
                                     lam=0.0)
    g = (w.T @ w).double()
    with pytest.raises(TypeError):
        hals_sweep.gs_sweep(h.double(), g, h.double(), lam=0.0, nsweeps=1)
    with pytest.raises(ValueError):
        mur_fused.mur_w_update(x, w, h, distance_type="eu", lam=0.0, with_lagged_obj=True)


@pytest.mark.cuda
def test_hals_and_masked_kernel_routes_match_plain_routes(cuda_device):
    x = t(lowrank()).float().to(cuda_device)
    kw = dict(min_iter=15, max_iter=15)
    before = hals_sweep.gs_sweep.launches
    k_run = tpunmf_torch.NMF(x, 5).factorize(method="hals", **kw)
    assert hals_sweep.gs_sweep.launches == before + 2 * 15
    p_run = tpunmf_torch.NMF(x, 5).factorize(method="hals", use_pallas=False, **kw)
    np.testing.assert_allclose(k_run.obj_history, p_run.obj_history, rtol=1e-4)
    mask = x > 0.5
    for dist in ("eu", "kl"):
        before = masked_fused.masked_w_update.launches
        k_run = tpunmf_torch.NMF(x, 5).factorize(method="mur", mask=mask,
                                                 distance_type=dist, **kw)
        assert masked_fused.masked_w_update.launches == before + 15
        p_run = tpunmf_torch.NMF(x, 5).factorize(method="mur", mask=mask, use_pallas=False,
                                                 distance_type=dist, **kw)
        np.testing.assert_allclose(k_run.obj_history, p_run.obj_history, rtol=1e-4)


@pytest.mark.cuda
def test_lagged_route_is_the_exact_route_shifted_by_one(cuda_device):
    x = t(lowrank()).float().to(cuda_device)
    kw = dict(method="mur", distance_type="kl", min_iter=20, max_iter=20,
              nndsvd_init=(True, "mean"))
    exact = tpunmf_torch.NMF(x, 5).factorize(**kw)
    before = mur_fused.mur_w_update.lagged_launches
    lagged = tpunmf_torch.NMF(x, 5).factorize(objective="lagged", **kw)
    assert mur_fused.mur_w_update.lagged_launches == before + 20
    np.testing.assert_allclose(lagged.obj_history[1:], exact.obj_history[:-1], rtol=1e-5)
    assert lagged.obj_history[0] == exact.obj_history[0]


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(1000, 777, 37), (1000, 777, 1536), (300, 260, 37),
                                   (130, 70, 1)])
def test_kl_ratio_and_obj_matches_plain_version(cuda_device, m, n, k, xdtype):
    """At ragged shapes of the 128 x 128 tiles: n odd (cells one by one)
    and n % 4 == 0 (16-byte loads and stores up to the ragged edge); at
    k = 37, 1536 (48 chunks of the tensor-core S tile) and 1."""
    x, w, h = _on(cuda_device, xdtype, m=m, n=n, k=k)
    assert bool((x == 0).any())
    before = fused.kl_ratio_and_obj.launches
    got_r, got_o = fused.kl_ratio_and_obj(x, w, h)
    assert fused.kl_ratio_and_obj.launches == before + 1
    want_r, want_o = fused.kl_ratio_and_obj_ref(x, w, h)
    assert got_r.dtype == torch.float32 and got_r.shape == x.shape
    torch.testing.assert_close(got_r, want_r, rtol=RTOL, atol=0)
    torch.testing.assert_close(got_o, want_o, rtol=RTOL, atol=0)
    # kl_obj's kernel is the same body without the ratio: the same bits
    assert torch.equal(fused.kl_obj(x, w, h), got_o)
    assert torch.equal(fused.kl_ratio_and_obj(x, w, h)[1], got_o)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(31, 37))
def test_eu_objective_near_convergence_holds_f32_accuracy(cuda_device, seed):
    """X = W0 H0 plus noise of about 1e-3 of X, and W, H within 1e-4 of W0,
    H0: 0.5 ||X - WH||^2 cancels in three of its digits, the regime in
    which MUR's convergence check reads it.  Against the value in float64
    on the same float32 inputs, the kernel is no worse than the plain
    float32 route (cuBLAS products), up to two ulps of the float32 result
    (each route rounds its own sum to float32).  S accumulated in the
    tensor cores alone was 5-21 ulps off here."""
    rng = np.random.default_rng(seed)
    m, n, k = 2000, 1500, 64
    w0, h0 = rng.random((m, k)), rng.random((k, n))
    x = (w0 @ h0) * (1.0 + 1e-3 * rng.standard_normal((m, n)))
    w = w0 * (1.0 + 1e-4 * rng.standard_normal((m, k)))
    h = h0 * (1.0 + 1e-4 * rng.standard_normal((k, n)))
    x, w, h = (a.astype(np.float32) for a in (x, w, h))
    d = x.astype(np.float64) - w.astype(np.float64) @ h.astype(np.float64)
    want = 0.5 * float(np.sum(d * d))
    xt, wt, ht = (t(a).to(cuda_device) for a in (x, w, h))
    got = float(fused.eu_residual_obj(xt, wt, ht))
    plain = float(fused.eu_residual_obj_ref(xt, wt, ht))
    ulp = float(np.spacing(np.float32(want)))
    assert abs(got - want) <= abs(plain - want) + 2 * ulp, (got, plain, want, ulp)


def _same_bits(got, want):
    """Equal values, NaN in the same places."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got, nan=0.0), torch.nan_to_num(want, nan=0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("b,n", [(4, 16384), (3, 40000), (70, 20000),
                                 (5, 20001)])  # rows off 16 bytes: scalar loads
@pytest.mark.parametrize("sel_block", [128, 256])
def test_blockmax_relayout_matches_plain_version_bit_for_bit(cuda_device, sel_block, b, n,
                                                             dtype):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(b * n)
    s = torch.randn((b, n), generator=g, device=cuda_device).to(dtype)
    s[b - 1, n // 3] = float("nan")  # propagates into its block's maximum
    s[0, :] = -float("inf")          # a fully excluded row stays -inf, not finfo.min
    before = topk_select.blockmax_relayout.launches
    got = topk_select.blockmax_relayout(s, sel_block)
    assert topk_select.blockmax_relayout.launches == before + 1
    want = topk_select.blockmax_relayout_ref(s, sel_block)
    for a, w in zip(got, want):
        _same_bits(a, w)
    assert int(torch.isnan(got[0][b - 1]).sum()) == 1
    assert bool((got[0][0, :n // sel_block] == -float("inf")).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("b,n,sel_block,offset", [
    (4, 16384, 128, 0), (4, 16384, 128, 1),  # scores on 16 bytes, or one value past them
    (2, 32768, 256, 0), (64, 1 << 20, 128, 0)])  # the serving shape
def test_blockmax_relayout_s3_is_a_view_and_maxima_are_amax(cuda_device, offset, sel_block,
                                                            n, b, dtype):
    """Where nbp * sel_block == n the kernel returns the scores as s3 and
    writes only the maxima: torch.amax of the view, bit for bit."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(b + n + offset)
    buf = torch.randn(b * n + offset, generator=g, device=cuda_device).to(dtype)
    s = buf[offset:].view(b, n)
    s[b - 1, n // 3] = float("nan")  # propagates into its block's maximum
    s[0, :] = -float("inf")          # a fully excluded row stays -inf
    before = topk_select.blockmax_relayout.launches
    bmax, s3 = topk_select.blockmax_relayout(s, sel_block)
    assert topk_select.blockmax_relayout.launches == before + 1
    assert s3.shape == (b, n // sel_block, sel_block)
    assert s3.data_ptr() == s.data_ptr()
    assert s3.untyped_storage().data_ptr() == s.untyped_storage().data_ptr()
    _same_bits(bmax, torch.amax(s.view(b, n // sel_block, sel_block), dim=2))
    assert int(torch.isnan(bmax).sum()) == 1
    assert bool(torch.isnan(bmax[b - 1, (n // 3) // sel_block]))
    assert bool((bmax[0] == -float("inf")).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hdtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,r,n", [(8, 128, 16384), (8, 37, 40000), (96, 128, 16384),
                                   (64, 512, 20000), (3, 1, 300)])
def test_score_blockmax_relayout_matches_plain_version(cuda_device, b, r, n, hdtype):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(b + r + n)
    w = torch.rand((b, r), generator=g, device=cuda_device).to(hdtype)
    h = torch.rand((r, n), generator=g, device=cuda_device).to(hdtype)
    before = topk_select.score_blockmax_relayout.launches
    got_m, got_s3 = topk_select.score_blockmax_relayout(w, h)
    assert topk_select.score_blockmax_relayout.launches == before + 1
    want_m, want_s3 = topk_select.score_blockmax_relayout_ref(w, h)
    assert got_m.dtype == got_s3.dtype == torch.float32
    torch.testing.assert_close(got_m, want_m, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got_s3, want_s3, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_score_blockmax_relayout_propagates_nan(cuda_device):
    w = torch.rand((5, 16), device=cuda_device)
    h = torch.rand((16, 40000), device=cuda_device)
    h[3, 777] = float("nan")
    got_m, got_s3 = topk_select.score_blockmax_relayout(w, h)
    assert bool(torch.isnan(got_m[:, 777 // 128]).all())
    assert int(torch.isnan(got_m).sum()) == 5
    assert bool(torch.isnan(got_s3.reshape(5, -1)[:, 777]).all())


@pytest.mark.cuda
def test_serving_wrappers_raise_instead_of_falling_back(cuda_device):
    s = torch.rand((3, 1000), device=cuda_device)
    with pytest.raises(TypeError):
        topk_select.blockmax_relayout(s.half())
    with pytest.raises(ValueError):
        topk_select.blockmax_relayout(s.T.contiguous().T)
    w, h = torch.rand((3, 1025), device=cuda_device), torch.rand((1025, 1000), device=cuda_device)
    with pytest.raises(ValueError):
        topk_select.score_blockmax_relayout(w, h)
    with pytest.raises(TypeError):
        topk_select.score_blockmax_relayout(w[:, :8].double(), h[:8].double())


@pytest.mark.cuda
def test_streamed_float64_panels_are_scored_as_float32(cuda_device):
    """Float64 numpy W and H: topk_streaming (four panels) sends each panel
    through as_input, so the card scores float32 and gives the values and
    indices of topk_retrieval on the whole H (as tpunmf does).  Multiples
    of 1/16 below 16 keep every score exact in float32, ties included."""
    rng = np.random.default_rng(27)
    w = rng.integers(0, 256, (6, 16)) / 16.0
    h = rng.integers(0, 256, (16, 50000)) / 16.0
    vals, idx = topk.topk_streaming(w, h, 50000, 10, panel_cols=16384)
    want_vals, want_idx = topk.topk_retrieval(None, w, h, 10)
    assert vals.is_cuda and vals.dtype == want_vals.dtype == torch.float32
    assert torch.equal(idx, want_idx)
    assert torch.equal(vals, want_vals)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"first_stage_dtype": "bf16"}, {"exclude": True}])
def test_serving_on_the_card_matches_the_cpu(cuda_device, kw):
    """Exact scores (multiples of 1/16): the card's answer, through its
    kernels, equals the CPU's, ties included."""
    rng = np.random.default_rng(17)
    w = (rng.integers(0, 16, (64, 32)) / 16).astype(np.float32)
    h = (rng.integers(0, 16, (32, 50000)) / 16).astype(np.float32)
    kw = dict(kw)
    if kw.pop("exclude", False):
        kw["exclude"] = rng.random((64, 50000)) < 0.1
    before = (topk_select.blockmax_relayout.launches,
              topk_select.score_blockmax_relayout.launches)
    got = topk.topk_retrieval(None, t(w).to(cuda_device), t(h).to(cuda_device), 100, **kw)
    want = topk.topk_retrieval(None, t(w), t(h), 100, **kw)
    after = (topk_select.blockmax_relayout.launches,
             topk_select.score_blockmax_relayout.launches)
    assert after[0] + after[1] > before[0] + before[1]
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("rho_mode", ["fixed", "adaptive"])
def test_admm_kernel_route_matches_plain_route(cuda_device, rho_mode, dist):
    x = t(lowrank()).float().to(cuda_device)
    kw = dict(method="admm", distance_type=dist, rho_mode=rho_mode, min_iter=20,
              max_iter=20, reg_h=(0.1, "l1n"))
    counter = fused.kl_ratio_and_obj if dist == "kl" else fused.eu_residual_obj
    before = counter.launches
    k_run = tpunmf_torch.NMF(x, 5).factorize(**kw)
    assert counter.launches == before + 20
    p_run = tpunmf_torch.NMF(x, 5).factorize(use_pallas=False, **kw)
    assert counter.launches == before + 20
    np.testing.assert_allclose(k_run.obj_history, p_run.obj_history, rtol=1e-4)


def _iteration(which, x, w, h, lam):
    if which == "eu":
        return (mur_fused.mur_iteration_eu(x, w, h, lam_w=lam, bm=x.shape[0]),
                mur_fused.mur_iteration_eu_ref(x, w, h, lam_w=lam))
    return (mur_fused.mur_iteration_kl(x, w, h, lam_w=lam, bm=x.shape[0]),
            mur_fused.mur_iteration_kl_ref(x, w, h, lam_w=lam))


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 128, 512])
@pytest.mark.parametrize("n", [777, 50001])  # one wave of rows; five, the last ragged
@pytest.mark.parametrize("which", ["eu", "kl"])
def test_iteration_kernels_match_plain_versions(cuda_device, which, n, k, xdtype):
    x, w, h = _on(cuda_device, xdtype, m=300, n=n, k=k)
    counter = getattr(mur_fused, "mur_iteration_" + which)
    before = counter.launches
    got, want = _iteration(which, x, w, h, lam=0.2)
    assert counter.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.is_cuda and a.shape == b.shape
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
    # every cross-block sum has a fixed order: the same inputs, the same bits
    again = _iteration(which, x, w, h, lam=0.2)[0]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_iteration_kl_objective_is_the_lagged_w_pass_s(cuda_device):
    x, w, h = _on(cuda_device, torch.float32, m=300, n=50001, k=37)
    obj = mur_fused.mur_iteration_kl(x, w, h, lam_w=0.0, bm=300)[2]
    torch.testing.assert_close(obj, fused.kl_obj_ref(x, w, h), rtol=RTOL, atol=0)
    lagged = mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=0.0,
                                    with_lagged_obj=True)[1]
    torch.testing.assert_close(obj, lagged, rtol=RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 128, 512, 1024])
@pytest.mark.parametrize("n", [776, 777])  # rows on 16 bytes (f32 and bf16), or not
def test_mur_iteration_eu_on_the_tensor_cores_at_ragged_shapes(cuda_device, n, k, xdtype):
    """m = 1000: the last 128-row tile of the wave is short; k up to 1024
    (8 tiles of 128); lam_w 0 and 0.2.  Every output within RTOL of the
    plain version, one launch a call, the same bits on a second call."""
    x, w, h = _on(cuda_device, xdtype, m=1000, n=n, k=k)
    for lam in (0.0, 0.2):
        before = mur_fused.mur_iteration_eu.launches
        got = mur_fused.mur_iteration_eu(x, w, h, lam_w=lam, bm=1000)
        assert mur_fused.mur_iteration_eu.launches == before + 1
        for a, b in zip(got, mur_fused.mur_iteration_eu_ref(x, w, h, lam_w=lam)):
            assert a.dtype == torch.float32 and a.is_cuda and a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
        again = mur_fused.mur_iteration_eu(x, w, h, lam_w=lam, bm=1000)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 128, 512, 1024])
@pytest.mark.parametrize("n", [776, 777])  # rows on 16 bytes (f32 and bf16), or not
@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_mur_h_update_over_row_splits(cuda_device, dist, n, k, xdtype):
    """m = 300, five 64-row tiles (the last short): the H pass over 1 split,
    2, 5 (one a tile), 7 (two of them empty) and the default count, lam 0
    and 0.2.  Each within RTOL of the plain version and of the others, one
    launch a call, the same bits on a second call with the same splits."""
    x, w, h = _on(cuda_device, xdtype, m=300, n=n, k=k)
    for lam in (0.0, 0.2):
        kw = dict(distance_type=dist, lam=lam)
        want = mur_fused.mur_h_update_ref(x, w, h, **kw)
        first = None
        for splits in (1, 2, 5, 7, None):
            before = mur_fused.mur_h_update.launches
            got = mur_fused.mur_h_update(x, w, h, splits=splits, **kw)
            assert mur_fused.mur_h_update.launches == before + 1
            for a, b in zip(got, want):
                assert a.dtype == torch.float32 and a.is_cuda and a.shape == b.shape
                assert torch.isfinite(a).all()
                torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
            first = first or got
            for a, b in zip(got, first):
                torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
            again = mur_fused.mur_h_update(x, w, h, splits=splits, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="splits=0"):
        mur_fused.mur_h_update(x, w, h, distance_type=dist, lam=0.0, splits=0)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [mur_fused.KL_H_TC_RANK, mur_fused.KL_H_TC_RANK + 1])
def test_kl_h_update_on_both_sides_of_the_tensor_core_rank(cuda_device, k, xdtype):
    """At KL_H_TC_RANK the KL H pass runs on the tensor cores over row
    splits; one above it, the FMA body over all rows, which ignores the
    split count (the same bits for any)."""
    x, w, h = _on(cuda_device, xdtype, m=300, n=277, k=k)
    want = mur_fused.mur_h_update_ref(x, w, h, distance_type="kl", lam=0.2)
    got = {sp: mur_fused.mur_h_update(x, w, h, distance_type="kl", lam=0.2, splits=sp)
           for sp in (1, 3)}
    for out in got.values():
        for a, b in zip(out, want):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
    if k > mur_fused.KL_H_TC_RANK:
        assert all(torch.equal(a, b) for a, b in zip(got[1], got[3]))
        assert mur_fused.h_splits(300, 277, k, "kl") == 1
    else:  # one split a 64-row tile of X
        assert mur_fused.h_splits(300, 277, k, "kl") == 5


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mur_iteration_eu", "mur_h_update"])
@pytest.mark.parametrize("seed", range(31, 37))
def test_gram_objective_near_convergence_holds_f32_accuracy(cuda_device, seed, which):
    """The Gram objective 0.5 (||X||^2 - 2 <W^T X, H> + <W^T W, H H^T>)
    from the kernels' W^T X (mur_iteration_eu's wtx and gram; mur_h_update's
    numerator) at X = W0 H0 plus noise of about 1e-3 of X, W and H within
    1e-4 of W0, H0: its three terms cancel to about 1e-6 of ||X||^2.
    Against the value in float64 on the same float32 factors, the kernels
    are no worse than cuBLAS's f32 products (TF32 off) up to GRAM_ULPS
    units in the last place of ||X||^2 in float32, the scale at which each
    term is rounded."""
    from tpunmf_torch.core.losses import eu_objective_gram
    from tpunmf_torch.core.precision import full_f32

    rng = np.random.default_rng(seed)
    m, n, k = 2000, 1500, 64
    w0, h0 = rng.random((m, k)), rng.random((k, n))
    x = (w0 @ h0) * (1.0 + 1e-3 * rng.standard_normal((m, n)))
    w = w0 * (1.0 + 1e-4 * rng.standard_normal((m, k)))
    h = h0 * (1.0 + 1e-4 * rng.standard_normal((k, n)))
    x, w, h = (a.astype(np.float32) for a in (x, w, h))
    xt, wt, ht = (t(a).to(cuda_device) for a in (x, w, h))
    with full_f32():
        if which == "mur_iteration_eu":
            wf, wtx, gram = mur_fused.mur_iteration_eu(xt, wt, ht, lam_w=0.0, bm=m)
        else:
            wf, wtx, gram = wt, mur_fused.mur_h_update(xt, wt, ht, distance_type="eu",
                                                       lam=0.0)[1], wt.T @ wt
        xsq = torch.sum(xt * xt)
        got = float(eu_objective_gram(xsq, wtx, gram, ht))
        plain = float(eu_objective_gram(xsq, wf.T @ xt, wf.T @ wf, ht))
    d = x.astype(np.float64) - wf.double().cpu().numpy() @ h.astype(np.float64)
    want = 0.5 * float(np.sum(d * d))
    ulp = float(np.spacing(np.float32(xsq.item())))
    assert abs(got - want) <= abs(plain - want) + GRAM_ULPS * ulp, (got, plain, want, ulp)



@pytest.mark.cuda
def test_iteration_wrappers_raise_instead_of_falling_back(cuda_device):
    x, w, h = _on(cuda_device, torch.float32)
    with pytest.raises(TypeError):
        mur_fused.mur_iteration_eu(x.double(), w, h, lam_w=0.0, bm=1000)
    with pytest.raises(ValueError):
        mur_fused.mur_iteration_kl(x.T.contiguous().T, w, h, lam_w=0.0, bm=1000)
    with pytest.raises(ValueError):
        mur_fused.mur_iteration_kl(x, w, h, lam_w=0.0, bm=7)


@pytest.mark.cuda
@pytest.mark.parametrize("dist,shape", [("eu", (64, 48)), ("kl", (128, 96))])
def test_single_pass_route_matches_plain_route(cuda_device, dist, shape):
    """Shapes that tpunmf's rule sends to the single pass."""
    x = t(lowrank(m=shape[0], n=shape[1])).float().to(cuda_device)
    kw = dict(method="mur", distance_type=dist, min_iter=5, max_iter=5,
              nndsvd_init=(True, "mean"))
    counter = getattr(mur_fused, "mur_iteration_" + dist)
    before = (counter.launches, mur_fused.mur_w_update.launches)
    k_run = tpunmf_torch.NMF(x, 5).factorize(**kw)
    assert (counter.launches, mur_fused.mur_w_update.launches) == (before[0] + 5, before[1])
    p_run = tpunmf_torch.NMF(x, 5).factorize(use_pallas=False, **kw)
    np.testing.assert_allclose(k_run.obj_history, p_run.obj_history, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numpy_input_runs_on_the_card(cuda_device, dtype):
    """float64 numpy goes to the card as float32 (as jnp.asarray makes it
    float32 in tpunmf) and takes the kernels."""
    before = mur_fused.mur_iteration_eu.launches
    res = tpunmf_torch.NMF(lowrank(m=64).astype(dtype), 5).factorize(
        method="mur", distance_type="eu", max_iter=5)
    assert mur_fused.mur_iteration_eu.launches == before + 5
    assert np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.obj_history))
    assert res.w.dtype == np.float32


# every launch counter of the port's kernels
COUNTERS = [(mur_fused.mur_w_update, "launches"), (mur_fused.mur_w_update, "lagged_launches"),
            (mur_fused.mur_h_update, "launches"), (mur_fused.mur_iteration_eu, "launches"),
            (mur_fused.mur_iteration_kl, "launches"), (fused.eu_residual_obj, "launches"),
            (fused.kl_obj, "launches"), (fused.kl_ratio, "launches"),
            (fused.kl_ratio_and_obj, "launches"), (hals_sweep.gs_sweep, "launches"),
            (masked_fused.masked_w_update, "launches"),
            (masked_fused.masked_h_update, "launches"),
            (topk_select.blockmax_relayout, "launches"),
            (topk_select.score_blockmax_relayout, "launches"),
            (mur_fused.mur_iteration_eu_dma, "launches"),
            (hals_sweep.hals_iteration_eu, "launches"), (mur_variants.v1_iter, "launches"),
            (mur_variants.v2_iter, "launches"), (mur_variants.iter_eu_int8, "launches"),
            (read_probe.read_probe, "launches")]


def _launches():
    return [getattr(fn, attr) for fn, attr in COUNTERS]


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 1024, 1025, 2048])
def test_kl_ratio_matches_plain_version(cuda_device, k, xdtype):
    x, w, h = _on(cuda_device, xdtype, m=300, n=277, k=k)
    assert bool((x == 0).any())
    before = fused.kl_ratio.launches
    got = fused.kl_ratio(x, w, h)
    assert fused.kl_ratio.launches == before + 1
    want = fused.kl_ratio_ref(x, w, h)
    assert got.dtype == torch.float32 and got.shape == x.shape and got.is_cuda
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0)
    assert torch.equal(got == 0, x == 0)
    # one owner per cell, k summed in a fixed order: the same bits again
    assert torch.equal(fused.kl_ratio(x, w, h), got)
    # the same ratio as kl_ratio_and_obj's kernel writes
    assert torch.equal(fused.kl_ratio_and_obj(x, w, h)[0], got)


@pytest.mark.cuda
def test_kernel_families_raise_past_their_rank_bounds(cuda_device):
    x, w, h = _on(cuda_device, torch.float32, m=64, n=48, k=2049)
    for fn in (fused.kl_ratio, fused.kl_obj, fused.eu_residual_obj):
        with pytest.raises(ValueError, match="outside"):
            fn(x, w, h)
    with pytest.raises(ValueError, match="outside"):
        fused.kl_ratio_and_obj(x, w, h)
    x, w, h = _on(cuda_device, torch.float32, m=64, n=48, k=1025)
    assert torch.isfinite(fused.kl_obj(x, w, h))  # the objectives take 1025
    with pytest.raises(ValueError, match="outside"):
        mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=0.0)
    with pytest.raises(ValueError, match="outside"):
        mur_fused.mur_h_update(x, w, h, distance_type="eu", lam=0.0)
    with pytest.raises(ValueError, match="outside"):
        masked_fused.masked_w_update(x, (x > 0).to(torch.uint8), w, h, distance_type="eu",
                                     lam=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["mur eu", "mur kl", "mask", "hals", "admm"])
def test_float64_numpy_takes_its_route_s_kernels(cuda_device, entry):
    """NMF(float64 numpy) runs on the card as float32 through the kernels
    its route takes, with finite factors and trace."""
    x = lowrank(m=64)
    kw = {"mur eu": dict(method="mur", distance_type="eu"),
          "mur kl": dict(method="mur", distance_type="kl"),
          "mask": dict(method="mur", distance_type="kl", mask=x > 0.5),
          "hals": dict(method="hals"),
          "admm": dict(method="admm", distance_type="eu")}[entry]
    if entry.startswith("mur "):
        route, _ = mur_route(torch.empty(x.shape, dtype=torch.float32, device="meta"), 5,
                             kw["distance_type"])
        update = (getattr(mur_fused, "mur_iteration_" + kw["distance_type"])
                  if route == "single" else mur_fused.mur_w_update)
        expect = {update: 5, fused.eu_residual_obj if entry == "mur eu" else fused.kl_obj: 6}
    else:
        expect = {"mask": {masked_fused.masked_w_update: 5, masked_fused.masked_h_update: 5},
                  "hals": {hals_sweep.gs_sweep: 10, fused.eu_residual_obj: 6},
                  "admm": {fused.eu_residual_obj: 5}}[entry]
    before = {fn: fn.launches for fn in expect}
    res = tpunmf_torch.NMF(x, 5).factorize(min_iter=5, max_iter=5, **kw)
    assert {fn: fn.launches - before[fn] for fn in expect} == expect
    assert res.w.dtype == np.float32
    assert np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h))
    assert np.all(np.isfinite(res.obj_history))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["mur eu", "mur kl", "mask", "hals", "admm"])
def test_a_cuda_float64_tensor_launches_no_kernel(cuda_device, entry):
    x = t(lowrank(m=64)).to(cuda_device)
    kw = {"mur eu": dict(method="mur", distance_type="eu"),
          "mur kl": dict(method="mur", distance_type="kl"),
          "mask": dict(method="mur", distance_type="kl", mask=x > 0.5),
          "hals": dict(method="hals"),
          "admm": dict(method="admm", distance_type="kl")}[entry]
    before = _launches()
    res = tpunmf_torch.NMF(x, 5).factorize(min_iter=5, max_iter=5, **kw)
    assert _launches() == before
    assert res.w.dtype == np.float64 and np.all(np.isfinite(res.obj_history))


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_high_rank_step_matches_plain_route(cuda_device, dist):
    """k = 1536: tpunmf's jnp step with the ratio and objective kernels,
    no update kernel, against the plain route over 5 iterations."""
    x = t(lowrank(m=300, n=277)).float().to(cuda_device)
    assert mur_route(x, 1536, dist) == ("high_rank", None)
    kw = dict(method="mur", distance_type=dist, min_iter=5, max_iter=5)
    before = _launches()
    k_run = tpunmf_torch.NMF(x, 1536).factorize(**kw)
    launched = dict(zip(COUNTERS, (a - b for a, b in zip(_launches(), before))))
    want = ({(fused.kl_ratio, "launches"): 5, (fused.kl_ratio_and_obj, "launches"): 6}
            if dist == "kl" else {(fused.eu_residual_obj, "launches"): 6})
    assert {c: n for c, n in launched.items() if n} == want
    before = _launches()
    p_run = tpunmf_torch.NMF(x, 1536).factorize(use_pallas=False, **kw)
    assert _launches() == before
    assert k_run.i == p_run.i == 4
    np.testing.assert_allclose(k_run.obj_history, p_run.obj_history, rtol=1e-4)


# ------------------------------------- the single passes behind the switches

@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 40, 128, 513])
@pytest.mark.parametrize("n", [777, 50001])  # one wave of rows; five, the last ragged
def test_hals_iteration_matches_plain_version(cuda_device, n, k, xdtype):
    x, w, h = _on(cuda_device, xdtype, m=300, n=n, k=k)
    for nsweeps, lam in ((1, 0.0), (2, 0.3)):
        before = hals_sweep.hals_iteration_eu.launches
        got = hals_sweep.hals_iteration_eu(x, w, h, lam_w=lam, nsweeps=nsweeps, bm=300)
        assert hals_sweep.hals_iteration_eu.launches == before + 1
        want = hals_sweep.hals_iteration_eu_ref(x, w, h, lam_w=lam, nsweeps=nsweeps)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.is_cuda and a.shape == b.shape
            assert torch.isfinite(a).all()
            # the sweeps clamp at 0: held to max |got - want| / max |want|
            assert _scaled_err(a, b) <= RTOL
        assert (got[0] >= 0).all()
        again = hals_sweep.hals_iteration_eu(x, w, h, lam_w=lam, nsweeps=nsweeps, bm=300)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 128, 512])
@pytest.mark.parametrize("n", [776, 777, 50001])  # rows on 16 bytes (f32 and bf16), or not
def test_mur_iteration_eu_dma_matches_plain_version_v1_iter_and_auto(cuda_device, n, k,
                                                                     xdtype):
    """The dma variant keeps the FMA tiles: at lam_w = 0 it is v1_iter bit
    for bit (the same FMAs in the same order); mur_iteration_eu takes its
    products on the tensor cores, so the two agree within ROUTE_RTOL."""
    x, w, h = _on(cuda_device, xdtype, m=300, n=n, k=k)
    before = (mur_fused.mur_iteration_eu_dma.launches, mur_fused.mur_iteration_eu.launches)
    got = mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.2, bm=150)
    assert (mur_fused.mur_iteration_eu_dma.launches,
            mur_fused.mur_iteration_eu.launches) == (before[0] + 1, before[1])
    want = mur_fused.mur_iteration_eu_dma_ref(x, w, h, lam_w=0.2)
    auto = mur_fused.mur_iteration_eu(x, w, h, lam_w=0.2, bm=150)
    for a, b, c in zip(got, want, auto):
        assert a.dtype == torch.float32 and a.is_cuda and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
        torch.testing.assert_close(a, c, rtol=ROUTE_RTOL[xdtype], atol=0)
    dma0 = mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.0, bm=150)
    assert all(torch.equal(a, b) for a, b in zip(dma0, mur_variants.v1_iter(x, w, h, bm=150)))


@pytest.mark.cuda
def test_opt_in_wrappers_raise_instead_of_falling_back(cuda_device):
    x, w, h = _on(cuda_device, torch.float32, m=64, n=48, k=8)
    with pytest.raises(TypeError):
        hals_sweep.hals_iteration_eu(x.double(), w, h, lam_w=0.0, nsweeps=1, bm=64)
    with pytest.raises(TypeError):
        mur_fused.mur_iteration_eu_dma(x.double(), w, h, lam_w=0.0, bm=32)
    with pytest.raises(TypeError):
        hals_sweep.hals_iteration_eu(x, w.double(), h.double(), lam_w=0.0, nsweeps=1, bm=64)
    with pytest.raises(ValueError, match="at least 2 strips"):
        mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.0, bm=64)
    with pytest.raises(ValueError):
        hals_sweep.hals_iteration_eu(x.T.contiguous().T, w, h, lam_w=0.0, nsweeps=1, bm=64)


def _launched_by(fn):
    before = _launches()
    out = fn()
    return out, {c: n for c, n in zip(COUNTERS, (a - b for a, b in zip(_launches(), before)))
                 if n}


@pytest.mark.cuda
def test_switches_route_the_single_passes_and_default_off(cuda_device, monkeypatch):
    """With tpunmf's defaults neither kernel runs; with the port's switches
    flipped, HALS and MUR EU launch exactly the single passes.  X has rank
    16, so at k = 8 and 5 the residual stays well above f32 rounding."""
    x = t(lowrank(m=64, k=16)).float().to(cuda_device)
    hals_kw = dict(method="hals", min_iter=5, max_iter=5, inner_sweeps=2)
    mur_kw = dict(method="mur", distance_type="eu", min_iter=5, max_iter=5,
                  nndsvd_init=(True, "mean"))
    hals_run, launched = _launched_by(lambda: tpunmf_torch.NMF(x, 8).factorize(**hals_kw))
    assert launched == {(hals_sweep.gs_sweep, "launches"): 10,
                        (fused.eu_residual_obj, "launches"): 6}
    auto_run, launched = _launched_by(lambda: tpunmf_torch.NMF(x, 5).factorize(**mur_kw))
    assert launched == {(mur_fused.mur_iteration_eu, "launches"): 5,
                        (fused.eu_residual_obj, "launches"): 6}
    monkeypatch.setattr(cuda_defaults, "hals_single_pass", lambda device: True)
    monkeypatch.setattr(cuda_defaults, "mur_single_pass_variant", lambda device: "dma")
    single_run, launched = _launched_by(lambda: tpunmf_torch.NMF(x, 8).factorize(**hals_kw))
    assert launched == {(hals_sweep.hals_iteration_eu, "launches"): 5,
                        (hals_sweep.gs_sweep, "launches"): 5,
                        (fused.eu_residual_obj, "launches"): 6}
    np.testing.assert_allclose(single_run.obj_history, hals_run.obj_history, rtol=1e-4)
    dma_run, launched = _launched_by(lambda: tpunmf_torch.NMF(x, 5).factorize(**mur_kw))
    assert launched == {(mur_fused.mur_iteration_eu_dma, "launches"): 5,
                        (fused.eu_residual_obj, "launches"): 6}
    # FMA tiles against the tensor cores: the same function, f32 sums in
    # another order
    np.testing.assert_allclose(dma_run.obj_history, auto_run.obj_history,
                               rtol=ROUTE_RTOL[torch.float32])
    np.testing.assert_allclose(dma_run.w, auto_run.w, rtol=ROUTE_RTOL[torch.float32])


# --------------------------- the sweep scripts' variants and the read probe

@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 128, 512])
@pytest.mark.parametrize("n", [777, 50001])  # one wave of rows; several, the last ragged
def test_v_iters_match_plain_versions_and_mur_iteration_eu(cuda_device, n, k, xdtype):
    x, w, h = _on(cuda_device, xdtype, m=300, n=n, k=k)
    before = (mur_variants.v1_iter.launches, mur_variants.v2_iter.launches)
    v1 = mur_variants.v1_iter(x, w, h, bm=150)
    v2 = mur_variants.v2_iter(x, w, h, bm=150)
    assert (mur_variants.v1_iter.launches, mur_variants.v2_iter.launches) == \
        (before[0] + 1, before[1] + 1)
    for got, want in ((v1, mur_variants.v1_iter_ref(x, w, h)),
                      (v2, mur_variants.v2_iter_ref(x, w, h))):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.is_cuda and a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
    # v1 is mur_iteration_eu's function at lam_w = 0; mur_iteration_eu
    # takes its products on the tensor cores, v1 on FMA tiles
    auto = mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=150)
    for a, b in zip(v1, auto):
        torch.testing.assert_close(a, b, rtol=ROUTE_RTOL[xdtype], atol=0)
    assert all(torch.equal(a, b) for a, b in zip((v2[0], v2[2], v2[3]), v1))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0.0, 0.5])  # X >= 0; X with negative values
@pytest.mark.parametrize("k", [1, 37, 128])
@pytest.mark.parametrize("n", [777, 50001])
def test_iter_eu_int8_matches_plain_version(cuda_device, n, k, shift):
    x, w, h = _on(cuda_device, torch.float32, m=300, n=n, k=k)
    xq, scale = sweep_int8.quantize(x - shift)
    assert bool((xq < 0).any()) == (shift > 0)
    before = mur_variants.iter_eu_int8.launches
    got = mur_variants.iter_eu_int8(xq, scale, w, h, bm=150)
    assert mur_variants.iter_eu_int8.launches == before + 1
    for a, b in zip(got, mur_variants.iter_eu_int8_ref(xq, scale, w, h)):
        assert a.dtype == torch.float32 and a.is_cuda and a.shape == b.shape
        if shift == 0.0:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
        else:  # signed sums cancel: max |got - want| / max |want|
            assert _scaled_err(a, b) <= RTOL
    again = mur_variants.iter_eu_int8(xq, scale, w, h, bm=150)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 777, 1000])
@pytest.mark.parametrize("offset", [0, 1])  # X on 16 bytes, or one float past them
def test_read_probe_matches_plain_version(cuda_device, n, offset):
    m = 384
    buf = torch.rand(m * n + offset, device=cuda_device)
    x = buf[offset:].view(m, n)
    for s in (0.0, torch.tensor(2.5, device=cuda_device)):
        before = read_probe.read_probe.launches
        got = read_probe.read_probe(x, s)
        assert read_probe.read_probe.launches == before + 1
        assert got.shape == (1, n) and got.dtype == torch.float32
        torch.testing.assert_close(got, read_probe.read_probe_ref(x, s), rtol=RTOL, atol=0)
        assert torch.equal(read_probe.read_probe(x, s), got)  # fixed-order sums


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(8192, 8192), (896, 777)])
def test_read_probe_is_one_launch_with_the_same_bits(cuda_device, m, n):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda_device)
    g.manual_seed(m + n)
    x = torch.rand((m, n), generator=g, device=cuda_device)
    s = torch.tensor(0.25, device=cuda_device)
    got = read_probe.read_probe(x, s)
    assert torch.equal(read_probe.read_probe(x, s), got)  # fixed-order sums, no atomics
    torch.testing.assert_close(got, read_probe.read_probe_ref(x, s), rtol=RTOL, atol=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        read_probe.read_probe(x, s)
        torch.cuda.synchronize()
    device_events = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA)
    assert device_events == 1


@pytest.mark.cuda
def test_read_rate_is_a_positive_rate(cuda_device):
    x = torch.rand((1024, 4096), device=cuda_device)
    before = read_probe.read_probe.launches
    rate = read_probe.read_rate(x, lo=2, hi=12)
    assert rate > 0 and read_probe.read_probe.launches == before + 3 * (2 + 12)


@pytest.mark.cuda
def test_variant_wrappers_raise_instead_of_falling_back(cuda_device):
    x, w, h = _on(cuda_device, torch.float32, m=64, n=48, k=8)
    xq, scale = sweep_int8.quantize(x)
    with pytest.raises(TypeError):
        mur_variants.v1_iter(x.double(), w, h, bm=32)
    with pytest.raises(TypeError):
        mur_variants.iter_eu_int8(x, scale, w, h, bm=32)
    with pytest.raises(ValueError):
        mur_variants.v2_iter(x.T.contiguous().T, w, h, bm=32)
    with pytest.raises(ValueError, match="must divide"):
        mur_variants.iter_eu_int8(xq, scale, w, h, bm=48)
    with pytest.raises(ValueError, match="contiguous"):
        read_probe.read_probe(torch.rand((256, 128), device=cuda_device).T, 0.0)


@pytest.mark.cuda
def test_sweep_loops_launch_their_kernels_on_the_card(cuda_device):
    """The v1 and v2 loops agree from one init (the same passes; v2's H
    update is its own kernel, v1's torch's), each launching only its kernel."""
    x, w, h = _on(cuda_device, torch.bfloat16, m=256, n=300, k=16)
    got = {}
    for make, fn in (("make_v1", mur_variants.v1_iter), ("make_v2", mur_variants.v2_iter)):
        got[make], launched = _launched_by(lambda: getattr(sweep_iter2, make)(64)(x, w, h, 5))
        assert launched == {(fn, "launches"): 5}
    torch.testing.assert_close(got["make_v1"], got["make_v2"], rtol=1e-4, atol=0)
    xq, scale = sweep_int8.quantize(x.float())
    (wq, hq, _), launched = _launched_by(lambda: sweep_int8.make_run(64)(xq, scale, w, h, 5))
    assert launched == {(mur_variants.iter_eu_int8, "launches"): 5}
    assert torch.isfinite(wq).all() and torch.isfinite(hq).all()
