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
from tpunmf_torch.ops import (_build, _launch, fused, hals_sweep, masked_fused, mur_fused,
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
# the KL objective near a fit against float64: chip_smoke.py's OBJECTIVE_RTOL
KL_FIT_RTOL = 1e-4
# a kernel route against float64 over a run: chip_smoke.py's F64_TOL
RUN_F64_RTOL = 1e-5
# the masked kernel route's distance from float64 over the plain f32
# route's: chip_smoke.py's F64_NEAR_PLAIN (here 1.0-1.2 on an H100 with
# the W pass's sums rounded, 2.9 and 7.7 with the tensor cores' own)
RUN_NEAR_PLAIN = 2.5


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
# 264 and 1024: 32- and 16-column blocks, ragged last panels; 8192 columns
# at k 128: the HALS path's shape, 128 blocks of 64 columns
@pytest.mark.parametrize("k,cols", [(1, 1000), (37, 1000), (128, 1000), (264, 1000),
                                    (513, 70), (1024, 70), (128, 8192)])
def test_gs_sweep_matches_plain_version(cuda_device, k, cols, nsweeps, lam, frame):
    a, g, v = _sweep_problem(cuda_device, frame, cols, k)
    assert v.is_contiguous() == (frame == "h" or k == 1)
    before = hals_sweep.gs_sweep.launches
    got = hals_sweep.gs_sweep(a, g, v, lam=lam, nsweeps=nsweeps)
    assert hals_sweep.gs_sweep.launches == before + 1
    assert got.stride() == v.stride()
    want = hals_sweep.gs_sweep_ref(a, g, v, lam=lam, nsweeps=nsweeps)
    assert torch.isfinite(got).all() and (got >= 0).all()
    assert _scaled_err(got, want) <= RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["w", "h"])
@pytest.mark.parametrize("k", [5, 128, 1024])
def test_gs_sweep_repeat_calls_give_the_same_bits(cuda_device, k, frame):
    """No atomics and a fixed order of sums: the same inputs give the same
    bits, call after call."""
    a, g, v = _sweep_problem(cuda_device, frame, 1000 if k < 500 else 70, k)
    first = hals_sweep.gs_sweep(a, g, v, lam=0.3, nsweeps=2)
    for _ in range(3):
        assert torch.equal(hals_sweep.gs_sweep(a, g, v, lam=0.3, nsweeps=2), first)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [37, 128, 513])
def test_gs_sweep_takes_transposed_views_and_a_strided_a(cuda_device, k):
    """The W frame's A and V as transposed views of row-major (m, k)
    tensors, the same made contiguous, and an A with neither stride 1 (every
    other column of a wider tensor): the kernel reads each through its
    strides, and its output keeps V's layout."""
    cols = 1000 if k < 500 else 70
    a, g, v = _sweep_problem(cuda_device, "w", cols, k)
    wide = torch.zeros((k, 2 * cols), device=cuda_device)
    wide[:, ::2] = a
    want = hals_sweep.gs_sweep_ref(a.contiguous(), g, v.contiguous(), lam=0.3, nsweeps=2)
    for aa in (a, a.contiguous(), wide[:, ::2]):
        for vv in (v, v.contiguous()):
            got = hals_sweep.gs_sweep(aa, g, vv, lam=0.3, nsweeps=2)
            assert got.stride() == vv.stride()
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
@pytest.mark.parametrize("seed", range(41, 44))
def test_kl_objective_near_a_fit_holds_f32_accuracy(cuda_device, seed):
    """X = W0 H0 with noise of 1e-3 of X, H 1% above H0, at k 256: the KL
    sum is about 5e-5 of sum(X) where sum(W H - X) is 1e-2 of it, so a
    bias of S reaches the objective two hundredfold.  Against its value in
    float64 on the same float32 inputs, the kernel (the KL passes' S
    rounded at every step) holds KL_FIT_RTOL, as the plain float32 route
    does; S accumulated in the tensor cores alone did not."""
    rng = np.random.default_rng(seed)
    m, n, k = 2000, 1500, 256
    w0, h0 = rng.random((m, k)), rng.random((k, n))
    x = (w0 @ h0) * (1.0 + 1e-3 * rng.standard_normal((m, n)))
    x, w, h = (a.astype(np.float32) for a in (x, w0, 1.01 * h0))
    xd, wh = x.astype(np.float64), w.astype(np.float64) @ h.astype(np.float64)
    want = float(np.sum(xd * np.log(xd / wh) - xd + wh))
    xt, wt, ht = (t(a).to(cuda_device) for a in (x, w, h))
    got = float(fused.kl_obj(xt, wt, ht))
    plain = float(fused.kl_obj_ref(xt, wt, ht))
    assert abs(plain / want - 1) <= KL_FIT_RTOL, (plain, want)
    assert abs(got / want - 1) <= KL_FIT_RTOL, (got, plain, want)
    assert torch.equal(fused.kl_ratio_and_obj(xt, wt, ht)[1], torch.tensor(got).to(xt))


@pytest.mark.cuda
def test_mur_kl_kernel_route_holds_float64(cuda_device):
    """50 MUR KL iterations at 8192 x 1024 r128 on the kernel route (the KL
    passes' S and numerators rounded at every step) stay within
    RUN_F64_RTOL of the same run in float64 at every iteration.  With
    the tensor cores' own sums, whose truncation falls one way over about
    a thousand steps, the route drifted to 1.3e-4 at 8192 x 8192."""
    from tpunmf_torch.data import tfidf_like
    from tpunmf_torch.init import random_init
    from tpunmf_torch.solvers import mur

    m, n, k = 8192, 1024, 128
    x = t(tfidf_like(m, n, n_topics=k, seed=4)).to(cuda_device)
    w0, h0 = random_init(0, m, n, k, device=cuda_device)
    kw = dict(distance_type="kl", min_iter=50, max_iter=50, tol1=0.0, tol2=0.0)
    want = np.asarray(mur(x.double(), k, w_init=w0.double(), h_init=h0.double(),
                          **kw).obj_history)
    assert mur_route(x, k, "kl")[0] in ("single", "pair")
    got = np.asarray(mur(x, k, w_init=w0, h_init=h0, **kw).obj_history)
    assert got.shape == want.shape == (51,)
    assert np.max(np.abs(got - want) / want) <= RUN_F64_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_masked_kernel_route_holds_float64(cuda_device, dist):
    """50 masked MUR iterations at 8192 x 1024 r64 with 25% of the cells
    observed (movielens_like ratings) on the kernel route (the masked W
    pass's numerator and denominator rounded at every step) stay within
    RUN_F64_RTOL of the same run in float64 at every iteration, and within
    RUN_NEAR_PLAIN times the plain f32 route's distance from it.  (On
    tfidf_like's 64 topics the EU fit is nearly exact, 0.5 ||M (X - W H)||^2
    falls from 1.8e9 to 10, and the plain f32 route is itself 2.2e-5 off
    float64 on the CPU.)"""
    from tpunmf_torch.data import movielens_like
    from tpunmf_torch.init import random_init
    from tpunmf_torch.solvers import mur_masked

    m, n, k = 8192, 1024, 64
    x = t(movielens_like(m, n, density=0.25, seed=3)).to(cuda_device)
    mask = x > 0
    w0, h0 = random_init(0, m, n, k, device=cuda_device)
    kw = dict(distance_type=dist, min_iter=50, max_iter=50, tol1=0.0, tol2=0.0)
    want = np.asarray(mur_masked(x.double(), mask, k, w_init=w0.double(), h_init=h0.double(),
                                 **kw).obj_history)
    plain = np.asarray(mur_masked(x, mask, k, w_init=w0, h_init=h0, use_pallas=False,
                                  **kw).obj_history)
    before = masked_fused.masked_w_update.launches, masked_fused.masked_h_update.launches
    got = np.asarray(mur_masked(x, mask, k, w_init=w0, h_init=h0, **kw).obj_history)
    assert (masked_fused.masked_w_update.launches, masked_fused.masked_h_update.launches) == (
        before[0] + 50, before[1] + 50)
    assert got.shape == plain.shape == want.shape == (51,)
    kernels = np.max(np.abs(got - want) / want)
    plain = np.max(np.abs(plain - want) / want)
    assert kernels <= RUN_F64_RTOL
    assert kernels <= RUN_NEAR_PLAIN * plain, (kernels, plain)


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
@pytest.mark.parametrize("wdtype,hdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
@pytest.mark.parametrize("b,r,n,sel_block,offset", [
    (8, 64, 777, 128, 1),       # H's rows off 4 bytes (16-bit), and its base
    (8, 64, 776, 128, 2),       # off 16 bytes (base off 16 too): the rows' covering chunks
    (200, 128, 40000, 128, 0),  # four user tiles; padding past n
    (64, 128, 40000, 256, 0),   # a block spans two column tiles
    (64, 1024, 20000, 128, 0)])  # depth 1024
def test_score_blockmax_relayout_on_its_load_paths(cuda_device, offset, sel_block, n, r, b,
                                                   hdtype, wdtype):
    """Within the scoring tolerance of the plain version on each of H's
    load paths; bmax is torch.amax of the stored s3 bit for bit, the
    columns past n hold finfo.min, and a second call gives the same bits."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(b + r + n + offset)
    w = torch.rand((b, r), generator=g, device=cuda_device).to(wdtype)
    buf = torch.rand(r * n + offset, generator=g, device=cuda_device).to(hdtype)
    h = buf[offset:].view(r, n)
    got_m, got_s3 = topk_select.score_blockmax_relayout(w, h, sel_block)
    want_m, want_s3 = topk_select.score_blockmax_relayout_ref(w, h, sel_block)
    torch.testing.assert_close(got_m, want_m, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got_s3, want_s3, rtol=2e-5, atol=2e-5)
    _same_bits(got_m, torch.amax(got_s3, dim=2))
    tail = got_s3.reshape(b, -1)[:, n:]
    assert tail.numel() > 0 or n % (128 * sel_block) == 0
    assert bool((tail == torch.finfo(torch.float32).min).all())
    again = topk_select.score_blockmax_relayout(w, h, sel_block)
    _same_bits(again[0], got_m)
    _same_bits(again[1], got_s3)


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
# across both KL rank lines (the W pass's 320, the H pass's 640)
@pytest.mark.parametrize("k", [1, 37, 128, 320, 512, 768])
@pytest.mark.parametrize("n", [777, 50001])
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
    assert _bits(obj) == _bits(lagged)


def _bits(a):
    """The bits of a float32 tensor, to compare two results bit for bit."""
    return a.contiguous().view(torch.int32).cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [37, mur_fused.KL_W_TC_RANK, 384, mur_fused.KL_ITER_PAIR_RANK, 768])
def test_iteration_kl_is_the_pair_s_passes(cuda_device, k, xdtype):
    """Up to KL_ITER_PAIR_RANK mur_iteration_kl runs the pair's KL bodies
    with their default splits: its W' and objective are the lagged KL W
    pass's, its wtr the KL H pass's numerator at that W', bit for bit (k 37
    and 320 on the tensor cores on both sides, 384 and 448 the W pass's FMA
    body and the H pass's tensor cores).  Above it (768) its FMA waves sum in
    another order: within RTOL of the pair's.  One launch, counted as
    mur_iteration_kl's alone; m = 1000 is ragged (not a multiple of 64)
    and n = 777 odd (H padded for the W pass, not for the H pass)."""
    x, w, h = _on(cuda_device, xdtype, m=1000, n=777, k=k)
    before = _launches()
    w_new, wtr, obj = mur_fused.mur_iteration_kl(x, w, h, lam_w=0.2, bm=1000)
    assert [a - b for a, b in zip(_launches(), before)] == \
        [int(c == (mur_fused.mur_iteration_kl, "launches")) for c in COUNTERS]
    w_pair, obj_pair = mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=0.2,
                                              with_lagged_obj=True)
    numer = mur_fused.mur_h_update(x, w_new, h, distance_type="kl", lam=0.2)[1]
    for got, pair in ((w_new, w_pair), (obj, obj_pair), (wtr, numer)):
        if mur_fused.iteration_kl_on_pair(k):
            assert _bits(got) == _bits(pair)
        else:
            torch.testing.assert_close(got, pair, rtol=RTOL, atol=0)


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
@pytest.mark.parametrize("entry", ["mur eu", "mur kl", "mask", "hals", "admm", "anls",
                                   "ao_admm"])
def test_float64_numpy_takes_its_route_s_kernels(cuda_device, entry):
    """NMF(float64 numpy) runs on the card as float32 through the kernels
    its route takes, with finite factors and trace."""
    x = lowrank(m=64)
    kw = {"mur eu": dict(method="mur", distance_type="eu"),
          "mur kl": dict(method="mur", distance_type="kl"),
          "mask": dict(method="mur", distance_type="kl", mask=x > 0.5),
          "hals": dict(method="hals"),
          "admm": dict(method="admm", distance_type="eu"),
          "anls": dict(method="anls", distance_type="kl"),
          "ao_admm": dict(method="ao_admm", distance_type="eu")}[entry]
    if entry.startswith("mur "):
        route, _ = mur_route(torch.empty(x.shape, dtype=torch.float32, device="meta"), 5,
                             kw["distance_type"])
        update = (getattr(mur_fused, "mur_iteration_" + kw["distance_type"])
                  if route == "single" else mur_fused.mur_w_update)
        expect = {update: 5, fused.eu_residual_obj if entry == "mur eu" else fused.kl_obj: 6}
    else:
        expect = {"mask": {masked_fused.masked_w_update: 5, masked_fused.masked_h_update: 5},
                  "hals": {hals_sweep.gs_sweep: 10, fused.eu_residual_obj: 6},
                  "admm": {fused.eu_residual_obj: 5},
                  "anls": {fused.kl_obj: 5},
                  "ao_admm": {fused.eu_residual_obj: 5}}[entry]
    before = {fn: fn.launches for fn in expect}
    res = tpunmf_torch.NMF(x, 5).factorize(min_iter=5, max_iter=5, **kw)
    assert {fn: fn.launches - before[fn] for fn in expect} == expect
    assert res.w.dtype == np.float32
    assert np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h))
    assert np.all(np.isfinite(res.obj_history))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["mur eu", "mur kl", "mask", "hals", "admm", "anls",
                                   "ao_admm", "ao_admm local"])
def test_a_cuda_float64_tensor_launches_no_kernel(cuda_device, entry):
    x = t(lowrank(m=64)).to(cuda_device)
    kw = {"mur eu": dict(method="mur", distance_type="eu"),
          "mur kl": dict(method="mur", distance_type="kl"),
          "mask": dict(method="mur", distance_type="kl", mask=x > 0.5),
          "hals": dict(method="hals"),
          "admm": dict(method="admm", distance_type="kl"),
          "anls": dict(method="anls", distance_type="kl"),
          "ao_admm": dict(method="ao_admm", distance_type="kl"),
          "ao_admm local": dict(method="ao_admm", distance_type="kl", rho_mode="adaptive",
                                reg_w=(0.1, "l1inf"))}[entry]
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
@pytest.mark.parametrize("n", [777, 50001])  # 50001: (A) over 88 column chunks of X
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
def test_hals_iteration_in_one_wave_above_rank_256(cuda_device, xdtype):
    """4096 x 3000 f32 is 48 MB, two L2-sized waves of rows (24 MB each);
    on the tensor cores all of X is one wave, and k = 264 ends in a short
    128-wide tile of k: within the plain version's scale, W' non-negative,
    the same bits again."""
    x, w, h = _on(cuda_device, xdtype, m=4096, n=3000, k=264)
    got = hals_sweep.hals_iteration_eu(x, w, h, lam_w=0.3, nsweeps=2, bm=4096)
    want = hals_sweep.hals_iteration_eu_ref(x, w, h, lam_w=0.3, nsweeps=2)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.is_cuda and a.shape == b.shape
        assert torch.isfinite(a).all()
        assert _scaled_err(a, b) <= RTOL
    assert (got[0] >= 0).all()
    again = hals_sweep.hals_iteration_eu(x, w, h, lam_w=0.3, nsweeps=2, bm=4096)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# HALS's single pass on the tensor cores: mur_iteration_eu's plan without
# its den block (m x k), counted in 64 bits
@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(8192, 8192, 128), (1000, 777, 40), (4096, 3000, 264),
                                   (2**23 + 1, 16, 256)])  # one wave of partials past INT_MAX
def test_hals_scratch_is_the_eu_plan_without_den(cuda_device, m, n, k):
    lib = _build.library()
    for x_bytes in (4, 2):
        hals = lib.tpunmf_iteration_scratch(m, n, k, x_bytes, _launch.WAVE_HALS)
        eu = lib.tpunmf_iteration_scratch(m, n, k, x_bytes, _launch.WAVE_MUR_EU_TC)
        assert eu - hals == m * k
        assert hals >= -(-m // 128) * 128 * k  # one partial of all of X's rows
    assert lib.tpunmf_iteration_scratch(2**23 + 1, 16, 256, 4, _launch.WAVE_HALS) > 2**31 - 1
    assert lib.tpunmf_iteration_scratch(m, n, k, 4, 4) == -1  # no such kind
    with pytest.raises(ValueError, match="no single-pass iteration"):
        _launch.wave_scratch(torch.empty((m, n), device="meta"), k, 4)


@pytest.mark.cuda
def test_hals_iteration_refuses_a_short_scratch(cuda_device):
    x, w, h = _on(cuda_device, torch.float32, m=1000, n=777, k=40)
    m, n, k = 1000, 777, 40
    lib = _build.library()
    floats = lib.tpunmf_iteration_scratch(m, n, k, 4, _launch.WAVE_HALS)
    scratch = torch.empty(floats, device=cuda_device)
    outs = (torch.empty_like(w), torch.empty_like(h), torch.empty((k, k), device=cuda_device))
    hht = h @ h.T
    stream = torch.cuda.current_stream().cuda_stream
    for length, status in ((floats, 0), (floats - 1, 1)):  # 1: cudaErrorInvalidValue
        assert lib.tpunmf_hals_iteration_eu(
            x.data_ptr(), 0, w.data_ptr(), h.data_ptr(), hht.data_ptr(), 0.0, m, n, k, 1,
            *(o.data_ptr() for o in outs), scratch.data_ptr(), length, stream) == status
    want = hals_sweep.hals_iteration_eu_ref(x, w, h, lam_w=0.0, nsweeps=1)
    assert all(_scaled_err(a, b) <= RTOL for a, b in zip(outs, want))


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 128, 512, 1024])  # 1024: the wrappers' MAX_RANK
# rows on 16 bytes (f32 and bf16), on 4 (f32; bf16 at 778), or neither (bf16 at 777, 50001)
@pytest.mark.parametrize("n", [776, 777, 778, 50001])
def test_mur_iteration_eu_dma_matches_plain_version_v1_iter_and_auto(cuda_device, n, k,
                                                                     xdtype):
    """The dma variant runs TMA and wgmma: at lam_w = 0 it is v1_iter bit
    for bit (the same stages on the same operands); mur_iteration_eu takes
    its products on mma.sync, its sums in another order, so the two agree
    within ROUTE_RTOL."""
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
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [776, 777, 778])  # bf16 rows on 16, off 4 and on 4 bytes
@pytest.mark.parametrize("m,bm", [(129, 43), (1000, 500)])  # not whole 128-row tiles
def test_tma_passes_at_a_ragged_m(cuda_device, m, bm, n, xdtype):
    """m past a whole number of the 128-row tiles (and of (B)'s 32- or
    64-row stages): the dma variant within RTOL of its plain version, v1_iter
    and v2_iter its bits at lam_w = 0."""
    x, w, h = _on(cuda_device, xdtype, m=m, n=n, k=128)
    for lam in (0.0, 0.2):
        got = mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=lam, bm=bm)
        for a, b in zip(got, mur_fused.mur_iteration_eu_dma_ref(x, w, h, lam_w=lam)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
    dma0 = mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.0, bm=bm)
    v1, v2 = mur_variants.v1_iter(x, w, h, bm), mur_variants.v2_iter(x, w, h, bm)
    assert all(torch.equal(a, b) for a, b in zip(dma0, v1))
    assert all(torch.equal(a, b) for a, b in zip((v2[0], v2[2], v2[3]), v1))


@pytest.mark.cuda
def test_tma_passes_refuse_a_short_scratch(cuda_device):
    """Both C entries of the pass on TMA and wgmma check the scratch
    against tpunmf_eu_tma_scratch's count (one float short: a nonzero
    status, nothing launched); with enough, within RTOL of the plain
    version."""
    m, n, k = 300, 50001, 40
    x, w, h = _on(cuda_device, torch.float32, m=m, n=n, k=k)
    lib = _build.library()
    floats = lib.tpunmf_eu_tma_scratch(m, n, k, 4)
    assert floats > 0
    scratch = torch.empty(floats, device=cuda_device)
    f0, f1, ldh = _launch.eu_tma_operands(x, h)
    gh = h @ h.T
    stream = torch.cuda.current_stream().cuda_stream
    want = mur_variants.v1_iter_ref(x, w, h)
    for length, status in ((floats, 0), (floats - 1, 1)):  # 1: cudaErrorInvalidValue
        outs = (torch.zeros_like(w), torch.zeros_like(h), torch.zeros((k, k), device=cuda_device))
        ptrs = tuple(o.data_ptr() for o in outs)
        assert lib.tpunmf_mur_iteration_eu_dma(
            x.data_ptr(), 0, w.data_ptr(), f0.data_ptr(), f1.data_ptr(), ldh, gh.data_ptr(), 0.0,
            m, n, k, *ptrs, scratch.data_ptr(), length, stream) == status
        if status == 0:
            for a, b in zip(outs, want):
                torch.testing.assert_close(a, b, rtol=RTOL, atol=0)
        assert lib.tpunmf_v1_iter(
            x.data_ptr(), 0, f0.data_ptr(), f1.data_ptr(), ldh, w.data_ptr(), gh.data_ptr(), m,
            n, k, *ptrs, scratch.data_ptr(), length, stream) == status
    torch.cuda.synchronize()


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
    # wgmma against mma.sync: the same function, f32 sums in another order
    np.testing.assert_allclose(dma_run.obj_history, auto_run.obj_history,
                               rtol=ROUTE_RTOL[torch.float32])
    np.testing.assert_allclose(dma_run.w, auto_run.w, rtol=ROUTE_RTOL[torch.float32])


# --------------------------- the sweep scripts' variants and the read probe

@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 128, 512, 1024])
@pytest.mark.parametrize("n", [777, 50001])  # X's rows off 16 bytes; wide
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
    # takes its products on mma.sync, v1 on wgmma
    auto = mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=150)
    for a, b in zip(v1, auto):
        torch.testing.assert_close(a, b, rtol=ROUTE_RTOL[xdtype], atol=0)
    assert all(torch.equal(a, b) for a, b in zip((v2[0], v2[2], v2[3]), v1))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0.0, 0.5])  # X >= 0; X with negative values
@pytest.mark.parametrize("k", [1, 37, 128])
# X's rows off 16 bytes (on 4, and off 4: the copies of their covering chunks), on 16 (TMA)
@pytest.mark.parametrize("n", [776, 777, 4096, 50001])
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
@pytest.mark.parametrize("k", [1, 37, 128, 1024])
@pytest.mark.parametrize("n", [776, 777, 4096])  # rows off 16 bytes (on 4, off 4), on 16
def test_iter_eu_int8_at_scale_one_is_v1_iter_on_widened_x(cuda_device, n, k):
    """int8 X widens to bf16 exactly in the consumers' registers and meets
    H in bf16 on the bf16 pass's stages, so at scale 1 its W', wtx and Gram
    are v1_iter's on xq.to(bfloat16), bit for bit (X with negative values);
    at the sweep script's scale, on X >= 0, within RTOL of the plain
    version.  (On signed X at k 1024 a W' one f32 ulp off the plain
    version's can round to the other bf16 for wtx: 2e-4 of max |wtx|
    measured on an H100, the one-bf16-ulp moves that ROUTE_RTOL covers; the
    k <= 128 cases of test_iter_eu_int8_matches_plain_version hold signed X
    to RTOL.)"""
    x, w, h = _on(cuda_device, torch.float32, m=300, n=n, k=k)
    xq, _ = sweep_int8.quantize(x - 0.5)
    one = torch.tensor(1.0, device=cuda_device)
    got = mur_variants.iter_eu_int8(xq, one, w, h, bm=150)
    v1 = mur_variants.v1_iter(xq.to(torch.bfloat16), w, h, bm=150)
    assert all(torch.equal(a, b) for a, b in zip(got, v1))
    xq, scale = sweep_int8.quantize(x)
    scaled = mur_variants.iter_eu_int8(xq, scale, w, h, bm=150)
    for a, b in zip(scaled, mur_variants.iter_eu_int8_ref(xq, scale, w, h)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_iter_eu_int8_refuses_a_short_scratch(cuda_device):
    """The C entry checks its scratch against tpunmf_eu_tma_scratch's count
    at 1-byte X (one float short: a nonzero status, nothing launched); with
    enough, the wrapper's outputs bit for bit."""
    m, n, k = 300, 4096, 40
    x, w, h = _on(cuda_device, torch.float32, m=m, n=n, k=k)
    xq, scale = sweep_int8.quantize(x)
    s = torch.as_tensor(scale, dtype=torch.float32, device=cuda_device).reshape(())
    lib = _build.library()
    floats = lib.tpunmf_eu_tma_scratch(m, n, k, 1)
    assert floats > 0
    scratch = torch.empty(floats, device=cuda_device)
    hb, _, ldh = _launch.eu_tma_operands(xq, h)
    gh = h @ h.T
    stream = torch.cuda.current_stream().cuda_stream
    want = mur_variants.iter_eu_int8(xq, scale, w, h, bm=150)
    for length, status in ((floats, 0), (floats - 1, 1)):  # 1: cudaErrorInvalidValue
        outs = (torch.zeros_like(w), torch.zeros_like(h), torch.zeros((k, k), device=cuda_device))
        assert lib.tpunmf_iter_eu_int8(
            xq.data_ptr(), hb.data_ptr(), ldh, w.data_ptr(), gh.data_ptr(), s.data_ptr(), m, n,
            k, *(o.data_ptr() for o in outs), scratch.data_ptr(), length, stream) == status
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want)) == (status == 0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["chol", "cg", "bpp"])
@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_anls_launches_its_objective_once_an_iteration_and_keeps_the_plain_bits(
        cuda_device, dist, solver):
    """ANLS's routes differ only in the objective: the kernel route launches
    eu_residual_obj or kl_obj once an iteration and nothing else, the plain
    route nothing, and the factors are the same bits."""
    x = t(lowrank()).float().to(cuda_device)
    kw = dict(method="anls", distance_type=dist, min_iter=10, max_iter=10,
              **{"chol": {}, "cg": dict(masked_solver="cg"),
                 "bpp": dict(nnls_solver="bpp")}[solver])
    obj = fused.kl_obj if dist == "kl" else fused.eu_residual_obj
    kern, launched = _launched_by(lambda: tpunmf_torch.NMF(x, 5).factorize(**kw))
    assert launched == {(obj, "launches"): 10}
    plain, launched = _launched_by(
        lambda: tpunmf_torch.NMF(x, 5).factorize(use_pallas=False, **kw))
    assert launched == {}
    np.testing.assert_array_equal(kern.w, plain.w)
    np.testing.assert_array_equal(kern.h, plain.h)
    np.testing.assert_allclose(kern.obj_history, plain.obj_history, rtol=1e-4)
    assert np.all(np.isfinite(kern.obj_history)) and kern.w.dtype == np.float32
    assert kern.w.min() >= 0 and kern.h.min() >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_anls_numpy_input_runs_on_the_card(cuda_device, dtype):
    res, launched = _launched_by(lambda: tpunmf_torch.NMF(lowrank(m=64).astype(dtype), 5)
                                 .factorize(method="anls", min_iter=5, max_iter=5))
    assert launched == {(fused.eu_residual_obj, "launches"): 5}
    assert res.w.dtype == np.float32 and np.all(np.isfinite(res.obj_history))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["chol", "cg", "bpp"])
def test_nnls_on_the_card_matches_the_cpu(cuda_device, solver):
    """The same exchanges on the card at float64 (first index on ties,
    cholesky_ex's NaN flag, no host check), a dead component included."""
    from tpunmf_torch.nnls import nnls_activeset, nnls_bpp

    rng = np.random.default_rng(0)
    c = rng.random((40, 10))
    c[:, 3] = 0.0
    a = c @ rng.random((10, 300)) + 0.5 * rng.standard_normal((40, 300))
    fn, kw = {"chol": (nnls_activeset, {}), "cg": (nnls_activeset, dict(solve_method="cg")),
              "bpp": (nnls_bpp, {})}[solver]
    cpu = fn(t(c.T @ c), t(c.T @ a), **kw)
    card = fn(t(c.T @ c).to(cuda_device), t(c.T @ a).to(cuda_device), **kw)
    assert card.is_cuda and torch.all(card[3] == 0)
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_transform_follows_x_new_s_device(cuda_device):
    """A model trained on the card (numpy W in its Results) encodes a CUDA
    x_new on the card and a CPU one on the CPU, with no kernel launched."""
    x = t(lowrank()).float()
    eu = tpunmf_torch.NMF(x.to(cuda_device), 5).fit(method="anls", min_iter=5, max_iter=5)
    kl = tpunmf_torch.NMF(x.to(cuda_device), 5).fit(method="anls", distance_type="kl",
                                                    min_iter=5, max_iter=5)
    for model in (eu, kl):
        (on_card, on_cpu, from_numpy), launched = _launched_by(lambda: (
            model.transform(x.to(cuda_device)), model.transform(x),
            model.transform(x.numpy())))
        assert launched == {}
        assert on_card.is_cuda and from_numpy.is_cuda and on_cpu.device.type == "cpu"
        torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-3, atol=1e-5)
        rec = model.inverse_transform(on_card)
        assert rec.is_cuda and rec.shape == x.shape


@pytest.mark.cuda
def test_a_diverging_local_sparsity_run_raises_nothing(cuda_device):
    """An l1 budget of 1, far below lowrank_dense's scale at rank 32: the
    iterates blow up, as tpunmf's do (tests/test_torch_ao_admm.py), and the
    run returns its trace, inf or NaN included, where torch.linalg.solve
    would raise on the card."""
    from tpunmf_torch.data import lowrank_dense

    x = torch.from_numpy(lowrank_dense(96, 80, 32, seed=0)).to(cuda_device)
    res = tpunmf_torch.NMF(x, 32).factorize(method="ao_admm", min_iter=40, max_iter=40,
                                            rho_mode="adaptive", reg_w=(0.1, "l1inf"))
    trace = np.asarray(res.obj_history, dtype=np.float64)
    assert len(trace) == 41 and np.nanmax(trace) > 1e6 * trace[0]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fixed", "local"])
@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_ao_admm_launches_its_objective_once_an_iteration_and_keeps_the_plain_bits(
        cuda_device, dist, variant):
    """AO-ADMM's routes differ only in the objective: the kernel route
    launches eu_residual_obj or kl_obj (never kl_ratio_and_obj) once an
    iteration and nothing else, the plain route nothing; the factors are the
    same bits and the inner loops take the same trips."""
    from tpunmf_torch.solvers.ao_admm import trips

    x, _, _ = _on(cuda_device, torch.float32)
    kw = dict(method="ao_admm", distance_type=dist, min_iter=5, max_iter=5,
              reg_h=(0.05, "l1n"),
              **({} if variant == "fixed" else dict(rho_mode="adaptive",
                                                    reg_w=(0.1, "l1inf"))))
    obj = fused.kl_obj if dist == "kl" else fused.eu_residual_obj
    runs = []
    for route in (True, False):
        trips.reset()
        res, launched = _launched_by(
            lambda: tpunmf_torch.NMF(x, 37).factorize(use_pallas=route, **kw))
        runs.append((res, launched, trips.as_dict()))
    (kern, k_launched, k_trips), (plain, p_launched, p_trips) = runs
    assert k_launched == {(obj, "launches"): 5} and p_launched == {}
    assert k_trips == p_trips and k_trips["h_calls"] == k_trips["w_calls"] == 5
    np.testing.assert_array_equal(kern.w, plain.w)
    np.testing.assert_array_equal(kern.h, plain.h)
    np.testing.assert_allclose(kern.obj_history, plain.obj_history, rtol=1e-4)
    assert np.all(np.isfinite(kern.obj_history)) and kern.w.dtype == np.float32
    assert kern.w.min() >= 0 and kern.h.min() >= 0


def _cp_problem(device, dims=(512, 96, 80), k=64, seed=21):
    """A CP-model tensor (+ noise) and an init, float32 on the card."""
    rng = np.random.default_rng(seed)
    fs = [rng.random((d, k)) + 0.01 for d in dims]
    x = np.einsum("ir,jr,kr->ijk", *fs) + 0.05 * rng.random(dims)
    init = [torch.from_numpy(rng.random((d, k)) + 0.01).float().to(device) for d in dims]
    return torch.from_numpy(x).float().to(device), init


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [0.0, 0.2])
def test_cp_hals_sweeps_match_the_plain_version(cuda_device, lam):
    """CP-HALS's component loop is gs_sweep in the transposed frame: one
    mode's update at (512, 64) against gs_sweep_ref, and one whole
    iteration (3 launches) against the plain route."""
    from tpunmf_torch.solvers import mttkrp, ntf
    from tpunmf_torch.solvers.ntf import _gram_except

    x, init = _cp_problem(cuda_device)
    grams = [f.T @ f for f in init]
    m, g = mttkrp(x, init, 0), _gram_except(grams, 0)
    got = hals_sweep.gs_sweep(m.T, g, init[0].T, lam=lam, nsweeps=1).T
    want = hals_sweep.gs_sweep_ref(m.T, g, init[0].T, lam=lam, nsweeps=1).T
    assert tuple(got.shape) == (512, 64) and got.is_contiguous()
    assert _scaled_err(got, want) <= RTOL
    kw = dict(update="hals", factors_init=init, lambdas=[lam] * 3, min_iter=1, max_iter=1)
    kern, launched = _launched_by(lambda: ntf(x, 64, use_pallas=True, **kw))
    plain, p_launched = _launched_by(lambda: ntf(x, 64, use_pallas=False, **kw))
    assert launched == {(hals_sweep.gs_sweep, "launches"): 3} and p_launched == {}
    for a, b in zip(kern.factors, plain.factors):
        assert _scaled_err(torch.from_numpy(a), torch.from_numpy(b)) <= RTOL
    np.testing.assert_allclose(kern.obj_history, plain.obj_history, rtol=RTOL)


@pytest.mark.cuda
def test_an_online_step_s_sweeps_match_the_plain_version(cuda_device):
    """One OnlineNMF minibatch from one state on both routes: the kernel
    route launches gs_sweep once (both sweeps), and W agrees."""
    from tpunmf_torch.solvers import OnlineNMF

    x, w0, _ = (t(a).to(cuda_device) for a in kernel_problem(22, m=512, n=256, k=64))
    models = []
    for route in (True, False):
        model = OnlineNMF(512, 64, sweeps=2, w_init=w0, use_pallas=route)
        h, launched = _launched_by(lambda: model.partial_fit(x))
        models.append((model, h, launched))
    (kern, hk, launched), (plain, hp, p_launched) = models
    assert launched == {(hals_sweep.gs_sweep, "launches"): 1} and p_launched == {}
    assert torch.equal(hk, hp)  # the encode precedes the sweeps
    assert _scaled_err(kern._w, plain._w) <= RTOL and kern.w.min() >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["gnmf", "nmtf"])
def test_gnmf_and_nmtf_routes_give_the_same_bits(cuda_device, solver):
    """gnmf's and nmtf's routes differ only in the objective, which does not
    feed back: eu_residual_obj once an iteration and once for the initial
    objective on the kernel route, nothing on the plain route, and the same
    W, H bits."""
    from tpunmf_torch import solvers

    x, w0, h0 = (t(a).to(cuda_device) for a in kernel_problem(23, m=300, n=200, k=16))
    if solver == "gnmf":
        a = solvers.knn_graph(x, 5)

        def fit(route):
            return solvers.gnmf(x, 16, a, w_init=w0, h_init=h0, min_iter=5, max_iter=5,
                                use_pallas=route)
    else:
        def fit(route):
            return solvers.nmtf(x, 8, 6, min_iter=5, max_iter=5, use_pallas=route)[0]
    kern, launched = _launched_by(lambda: fit(True))
    plain, p_launched = _launched_by(lambda: fit(False))
    assert launched == {(fused.eu_residual_obj, "launches"): 6} and p_launched == {}
    np.testing.assert_array_equal(kern.w, plain.w)
    np.testing.assert_array_equal(kern.h, plain.h)
    np.testing.assert_allclose(kern.obj_history, plain.obj_history, rtol=RTOL)


def _streamed_problem(seed=33, m=1000, n=777, k=37):
    """A scipy CSR matrix about 60% zeros with an all-zero column band (empty
    tiles at 256 x 200), and float32 inits."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    dense = rng.random((m, n)).astype(np.float32)
    dense[dense < 0.6] = 0.0
    dense[:, 200:400] = 0.0
    w0 = torch.from_numpy(rng.random((m, k)).astype(np.float32) + 0.1)
    h0 = torch.from_numpy(rng.random((k, n)).astype(np.float32) + 0.1)
    return sp.csr_matrix(dense), w0, h0


@pytest.mark.cuda
@pytest.mark.parametrize("transfer", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_streamed_kl_kernel_route_matches_its_plain_route(cuda_device, transfer):
    """Out-of-core MUR KL on a ragged tile grid: on the card each nonempty
    tile's ratio is kl_ratio (twice an iteration) and its objective kl_obj
    (once an objective), within 1e-5 of the plain route, which launches
    neither."""
    from tpunmf_torch.solvers import mur_streaming

    csr, w0, h0 = _streamed_problem()
    kw = dict(k=37, w_init=w0.to(cuda_device), h_init=h0.to(cuda_device), distance_type="kl",
              row_block=256, col_panel=200, min_iter=5, max_iter=5, tol1=0.0, tol2=0.0,
              transfer_dtype=transfer)
    nonempty = 4 * 4 - 4  # column panel 1 (200-399) is empty in every row block
    got, launched = _launched_by(lambda: mur_streaming(csr, **kw))
    want, p_launched = _launched_by(lambda: mur_streaming(csr, use_pallas=False, **kw))
    assert launched == {(fused.kl_ratio, "launches"): 2 * nonempty * 5,
                        (fused.kl_obj, "launches"): nonempty * 6} and p_launched == {}
    np.testing.assert_allclose(got.obj_history, want.obj_history, rtol=1e-5)
    for a, b in ((got.w, want.w), (got.h, want.h)):
        assert _scaled_err(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dist,transfer", [("eu", None), ("kl", None), ("kl", torch.bfloat16)])
def test_the_ring_never_overwrites_a_panel_in_flight(cuda_device, dist, transfer, monkeypatch):
    """A ring of two pinned buffers and two device panels over 24 tiles:
    the pipelined run equals the same run with a synchronize after every
    panel, bit for bit (a panel overwritten in flight would change them)."""
    import importlib

    from tpunmf_torch.data import pipeline

    streaming = importlib.import_module("tpunmf_torch.solvers.streaming")
    monkeypatch.setattr(streaming, "RING_SLOTS", 2)
    csr, w0, h0 = _streamed_problem(seed=34, m=3000, n=1600, k=64)
    kw = dict(w_init=w0.to(cuda_device), h_init=h0.to(cuda_device), distance_type=dist,
              row_block=512, col_panel=400, min_iter=3, max_iter=3, tol1=0.0, tol2=0.0,
              transfer_dtype=transfer)
    piped = streaming.mur_streaming(csr, 64, **kw)
    real = pipeline.PanelPipeline.run

    def synchronized(self, *args, **kwargs):
        for out in real(self, *args, **kwargs):
            yield out
            torch.cuda.synchronize()

    monkeypatch.setattr(pipeline.PanelPipeline, "run", synchronized)
    synced = streaming.mur_streaming(csr, 64, **kw)
    np.testing.assert_array_equal(piped.w, synced.w)
    np.testing.assert_array_equal(piped.h, synced.h)
    assert piped.obj_history == synced.obj_history


@pytest.mark.cuda
def test_streamed_panels_from_a_callable_match_the_whole_h(cuda_device):
    """topk_streaming through the pinned ring: a callable source, a ragged
    last panel (5 panels, more than the ring's slots) and exclusions give
    topk_retrieval's values and indices on the whole H, ties included
    (multiples of 1/16 keep every score exact)."""
    rng = np.random.default_rng(35)
    w = (rng.integers(0, 16, (8, 32)) / 16).astype(np.float32)
    h = (rng.integers(0, 16, (32, 70000)) / 16).astype(np.float32)
    exclude = rng.random((8, 70000)) < 0.05
    vals, idx = topk.topk_streaming(t(w).to(cuda_device), lambda s, e: h[:, s:e], 70000, 50,
                                    panel_cols=16384, exclude=exclude)
    want_vals, want_idx = topk.topk_retrieval(None, t(w).to(cuda_device),
                                              t(h).to(cuda_device), 50, exclude=exclude)
    assert torch.equal(idx, want_idx)
    assert torch.equal(vals, want_vals)


@pytest.fixture
def card_mesh(cuda_device):
    """A "cuda" mesh (1,) 'cols' over NCCL: the card's machine has one card,
    so a world of one rank (build_mesh brings it up in this process)."""
    from tpunmf_torch import parallel

    return parallel.build_mesh((1,), ("cols",))


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("driver", ["mesh", "ulysses", "rank"])
def test_mur_over_a_card_mesh_matches_one_device(card_mesh, driver, dist):
    """The facade's mesh= and both schedules on a CUDA X with no argument
    naming a device: the one-device trace over the first iterations, the
    update kernels once an iteration where both halves are local."""
    x = t(lowrank(m=600, n=480, k=8)).float().cuda()
    w0, h0 = (torch.rand(s, device=x.device) + 0.1 for s in ((600, 8), (8, 480)))
    kw = dict(method="mur", distance_type=dist, w_init=w0, h_init=h0, min_iter=10,
              max_iter=10, tol1=0.0, tol2=0.0)
    want = tpunmf_torch.NMF(x, 8).factorize(**kw)
    before = mur_fused.mur_w_update.launches
    if driver == "mesh":
        got = tpunmf_torch.NMF(x, 8, mesh=card_mesh).factorize(**kw)
    else:
        got = tpunmf_torch.NMF(x, 8).factorize(schedule=driver, mesh=card_mesh, **kw)
    assert mur_fused.mur_w_update.launches - before == (0 if driver == "rank" else 10)
    np.testing.assert_allclose(got.obj_history, want.obj_history, rtol=RTOL)
    np.testing.assert_allclose(got.w, want.w, rtol=RTOL, atol=RTOL * np.abs(want.w).max())


@pytest.mark.cuda
def test_sharded_serving_and_streaming_on_a_card_mesh(card_mesh):
    import scipy.sparse as sp

    from tpunmf_torch.solvers import mur_streaming, mur_streaming_sharded

    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.rand((16, 32), generator=g, device="cuda")
    h = torch.rand((32, 70000), generator=g, device="cuda")
    want = topk.topk_retrieval(None, w, h, 50)
    got = topk.topk_retrieval(card_mesh, w, h, 50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = topk.topk_streaming(w, h.cpu().numpy(), 70000, 50, panel_cols=16384, mesh=card_mesh)
    assert torch.equal(got[1], want[1])

    csr = sp.random(3000, 2000, density=0.05, format="csr", random_state=4,
                    dtype=np.float32)
    w0, h0 = (torch.rand(s, device="cuda") + 0.1 for s in ((3000, 6), (6, 2000)))
    kw = dict(distance_type="kl", w_init=w0, h_init=h0, min_iter=5, max_iter=5, tol1=0.0,
              tol2=0.0)
    before = fused.kl_ratio.launches
    got = mur_streaming_sharded(csr, 6, card_mesh, row_block=1024, **kw)
    assert fused.kl_ratio.launches - before == 2 * 3 * 5
    want = mur_streaming(csr, 6, row_block=1024, col_panel=2000, **kw)
    np.testing.assert_allclose(got.obj_history, want.obj_history, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("method,options,kernel", [
    ("hals", {}, "gs_sweep"),
    ("anls", {}, "eu_residual_obj"),
    ("anls", {"distance_type": "kl", "nnls_solver": "bpp"}, "kl_obj"),
    ("admm", {"reg_h": (0.1, "l1n")}, "eu_residual_obj"),
    ("admm", {"distance_type": "kl"}, "kl_ratio_and_obj"),
    ("ao_admm", {}, "eu_residual_obj"),
    ("ao_admm", {"distance_type": "kl", "reg_w": (0.05, "l1n")}, "kl_obj"),
    ("mur", {"mask": True, "distance_type": "eu"}, "masked_w_update"),
    ("mur", {"mask": True, "distance_type": "kl"}, "masked_h_update"),
])
def test_methods_over_a_card_mesh_match_one_device(card_mesh, method, options, kernel):
    """The facade's mesh= for the reference solvers on a world of one: the
    one-device run's trace, its kernels launched as many times, and the
    plain route within RTOL."""
    x = t(lowrank(m=600, n=480, k=8)).float().cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    w0, h0 = (torch.rand(s, generator=g, device="cuda") + 0.1 for s in ((600, 8), (8, 480)))
    kw = dict(method=method, w_init=w0, h_init=h0, min_iter=8, max_iter=8, tol1=0.0, tol2=0.0,
              **options)
    if kw.pop("mask", False):
        kw["mask"] = torch.rand(x.shape, generator=g, device="cuda") < 0.6
    wrapper = {"gs_sweep": hals_sweep.gs_sweep, "eu_residual_obj": fused.eu_residual_obj,
               "kl_obj": fused.kl_obj, "kl_ratio_and_obj": fused.kl_ratio_and_obj,
               "masked_w_update": masked_fused.masked_w_update,
               "masked_h_update": masked_fused.masked_h_update}[kernel]
    before = wrapper.launches
    want = tpunmf_torch.NMF(x, 8).factorize(**kw)
    one_device = wrapper.launches - before
    got = tpunmf_torch.NMF(x, 8, mesh=card_mesh).factorize(**kw)
    assert one_device > 0 and wrapper.launches - before == 2 * one_device
    np.testing.assert_allclose(got.obj_history, want.obj_history, rtol=1e-6)
    np.testing.assert_allclose(got.w, want.w, rtol=RTOL, atol=RTOL * np.abs(want.w).max())
    plain = tpunmf_torch.NMF(x, 8, mesh=card_mesh).factorize(use_pallas=False, **kw)
    assert wrapper.launches - before == 2 * one_device
    np.testing.assert_allclose(plain.obj_history[:6], got.obj_history[:6], rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dist,update", [("eu", "mur"), ("eu", "hals"), ("kl", "mur")])
def test_ntf_sharded_on_a_card_mesh_matches_ntf(cuda_device, dist, update):
    """ntf_sharded over a "cuda" mesh (1,) 'rows' against the one-device
    ntf from one init; CP-HALS sweeps on gs_sweep, one launch a mode."""
    from tpunmf_torch import parallel
    from tpunmf_torch.solvers import ntf

    mesh = parallel.build_mesh((1,), ("rows",))
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand((40, 30, 20), generator=g, device="cuda")
    init = [torch.rand((s, 6), generator=g, device="cuda") + 0.1 for s in x.shape]
    kw = dict(distance_type=dist, update=update, min_iter=10, max_iter=10, tol1=0.0, tol2=0.0,
              factors_init=init)
    want = ntf(x, 6, normalize=False, **kw)
    before = hals_sweep.gs_sweep.launches
    got = parallel.ntf_sharded(mesh, x, 6, **kw)
    assert hals_sweep.gs_sweep.launches - before == (30 if update == "hals" else 0)
    np.testing.assert_allclose(got.obj_history, want.obj_history, rtol=1e-6)
    plain = parallel.ntf_sharded(mesh, x, 6, use_pallas=False, **kw)
    np.testing.assert_allclose(plain.obj_history, got.obj_history, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_lambda_grid_over_a_card_mesh(cuda_device, dist):
    from tpunmf_torch import experiments, parallel

    mesh = parallel.build_mesh((1,), ("grid",))
    x = t(lowrank(m=600, n=480, k=8)).float().cuda()
    kw = dict(lambda_w=(0.0, 0.1), lambda_h=(0.0, 0.05), n_iter=6, distance_type=dist, key=2)
    want = experiments.mur_lambda_grid(x, 8, **kw)
    got = experiments.mur_lambda_grid(x, 8, mesh=mesh, **kw)
    assert got[0] == want[0]
    torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=0)


@pytest.fixture
def card_mesh11(cuda_device):
    """A "cuda" mesh (1, 1) 'rows' x 'cols' over NCCL, a world of one."""
    from tpunmf_torch import parallel

    return parallel.build_mesh((1, 1), ("rows", "cols"))


@pytest.mark.cuda
@pytest.mark.parametrize("method,options,kernel", [
    ("semi_nmf", {}, "eu_residual_obj"),
    ("onmf", {"orthogonal": "w"}, "eu_residual_obj"),
    ("robust", {}, None),
    ("mur", {"beta": 0.5}, None),
    ("ntf", {"update": "hals"}, "gs_sweep"),
])
def test_new_drivers_over_a_card_mesh_hold_one_device_bits(card_mesh11, method, options,
                                                           kernel):
    """semi-NMF, ONMF, robust NMF, beta= and ntf through the facade's mesh=
    on a (1, 1) world of one: the one-device run's bits (the same
    expressions on the same blocks), its kernels launched as many times."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = t(lowrank(m=600, n=480, k=8)).float().cuda()
    kw = dict(method=method, min_iter=8, max_iter=8, tol1=0.0, tol2=0.0, **options)
    if method == "ntf":
        x = x.reshape(600, 24, 20)
        kw["factors_init"] = [torch.rand((s, 8), generator=g, device="cuda") + 0.1
                              for s in x.shape]
    else:
        if method == "semi_nmf":
            x = x - x.mean(dim=0)
        kw["w_init"] = torch.rand((600, 8), generator=g, device="cuda") + 0.1
        kw["h_init"] = torch.rand((8, 480), generator=g, device="cuda") + 0.1
    wrapper = {"gs_sweep": hals_sweep.gs_sweep,
               "eu_residual_obj": fused.eu_residual_obj}.get(kernel)
    before = wrapper.launches if wrapper else 0
    want = tpunmf_torch.NMF(x, 8).factorize(**kw)
    one_device = wrapper.launches - before if wrapper else 0
    got = tpunmf_torch.NMF(x, 8, mesh=card_mesh11).factorize(**kw)
    if wrapper:
        assert one_device > 0 and wrapper.launches - before == 2 * one_device
    assert got.i == want.i == 7
    np.testing.assert_array_equal(got.obj_history, want.obj_history)
    fields = ((got.factors, want.factors) if method == "ntf"
              else ((got.w, got.h), (want.w, want.h)))
    for a, b in zip(*fields):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["npz", "dcp"])
def test_hals_checkpoint_resumes_on_a_card_mesh(card_mesh11, backend, tmp_path):
    """HALS over a (1, 1) card mesh in blocks of 4, stopped after a block
    and resumed, gives the uninterrupted run's bits; the .npz resumes in
    one-device hals with the same bits."""
    from _torch_parity import run_interrupted
    from tpunmf_torch.solvers import hals

    g = torch.Generator(device="cuda").manual_seed(8)
    x = t(lowrank(m=600, n=480, k=8)).float().cuda()
    kw = dict(w_init=torch.rand((600, 8), generator=g, device="cuda") + 0.1,
              h_init=torch.rand((8, 480), generator=g, device="cuda") + 0.1, min_iter=12,
              max_iter=12, tol1=0.0, tol2=0.0)
    model = tpunmf_torch.NMF(x, 8, mesh=card_mesh11)
    full = model.factorize(method="hals", **kw)
    path = str(tmp_path / "ck")
    run_interrupted(lambda **k: model.factorize(method="hals", checkpoint_backend=backend,
                                                **k, **kw), path, 4, 1)
    got = model.factorize(method="hals", checkpoint_path=path, checkpoint_every=4, resume=True,
                          checkpoint_backend=backend, **kw)
    for a, b in ((got.obj_history, full.obj_history), (got.w, full.w), (got.h, full.h)):
        np.testing.assert_array_equal(a, b)
    if backend == "npz":
        path = str(tmp_path / "ck2")
        run_interrupted(lambda **k: model.factorize(method="hals", **k, **kw), path, 4, 1)
        one = hals(x, 8, checkpoint_path=path, checkpoint_every=4, resume=True, **kw)
        want = hals(x, 8, **kw)
        for a, b in ((one.obj_history, want.obj_history), (one.w, want.w)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [0, 2])
def test_baseline_configs_hold_the_float64_gate(cuda_device, idx):
    """BASELINE configs 0 (MUR EU) and 2 (ANLS + FCNNLS) at scale 0.1 on the
    card: the kernel route's final error within chip_smoke.py phase 13's
    gate of the float64 plain route's, its kernels launched."""
    from tpunmf_torch.ops import fused
    from tpunmf_torch.sweeps import run_configs

    before = fused.eu_residual_obj.launches
    got = run_configs.runners()[idx](0.1, device=cuda_device)
    held, tol = run_configs.gate(got)
    assert held, (got["final_err_deviation"], tol)
    assert fused.eu_residual_obj.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("method,options", [
    ("ao_admm", dict(distance_type="kl", reg_w=(0.05, "l1n"), reg_h=(0.05, "l2n"))),
    ("admm", dict(reg_h=(0.1, "l1n"))),
    ("anls", dict(use_fcnnls=True)),
])
def test_nndsvd_inits_over_a_card_mesh_hold_one_device_bits(card_mesh11, method, options):
    """From NNDSVD's column-major U, one device and a (1, 1) world of one
    give the same bits: both take the factors row-major (BASELINE config 4
    drifted 6e-5 apart over 60 iterations when one device kept U's layout)."""
    from tpunmf_torch.solvers import admm, anls, ao_admm

    x = t(lowrank(m=600, n=480, k=8)).float().cuda()
    kw = dict(min_iter=12, max_iter=12, tol1=0.0, tol2=0.0, nndsvd_init=(True, "zero"),
              **options)
    one = {"ao_admm": ao_admm, "admm": admm, "anls": anls}[method](x, 8, **kw)
    mesh = tpunmf_torch.NMF(x, 8, mesh=card_mesh11).factorize(method=method, **kw)
    for a, b in ((mesh.obj_history, one.obj_history), (mesh.w, one.w), (mesh.h, one.h)):
        np.testing.assert_array_equal(a, b)
