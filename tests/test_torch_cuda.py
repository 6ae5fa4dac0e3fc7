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
from tpunmf_torch.ops import fused, hals_sweep, masked_fused, mur_fused

# f32 sums of positive terms in another order (see chip_smoke.py)
RTOL = 1e-4


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
@pytest.mark.parametrize("k", [1, 64, 513, 1024])
def test_kl_updates_cover_the_rank_range(cuda_device, k):
    """k = 513..1024 takes the halved KL blocks (kWideRank in mur_update.cu)."""
    x, w, h = _on(cuda_device, torch.float32, m=130, n=70, k=k)
    for fn, ref in ((mur_fused.mur_w_update, mur_fused.mur_w_update_ref),
                    (mur_fused.mur_h_update, mur_fused.mur_h_update_ref)):
        for a, b in _pairs(fn(x, w, h, distance_type="kl", lam=0.1),
                           ref(x, w, h, distance_type="kl", lam=0.1)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0)


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
    """k = 257..512 and 513..1024 take the halved and quartered blocks."""
    x, mask, w, h = (t(a).to(cuda_device) for a in masked_problem(15, m=130, n=70, k=k))
    for dist in ("eu", "kl"):
        for fn, ref in ((masked_fused.masked_w_update, masked_fused.masked_w_update_ref),
                        (masked_fused.masked_h_update, masked_fused.masked_h_update_ref)):
            torch.testing.assert_close(
                fn(x, mask.to(torch.uint8), w, h, distance_type=dist, lam=0.1),
                ref(x, mask, w, h, distance_type=dist, lam=0.1), rtol=RTOL, atol=0)


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
