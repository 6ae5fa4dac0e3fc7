"""tpunmf_torch's masked MUR against tpunmf's: the half-updates' plain
versions against tpunmf's Pallas kernels (interpret mode), and the solver
iterate for iterate at float64 on the CPU (traces to 1e-10, the same ``i``),
on both of the port's routes."""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import (F64_RUN, PLAIN_F64_RTOL, assert_traces_match, f32, f64_distance,
                           masked_problem, t)
from tpunmf.data import synthetic as jsynthetic
from tpunmf.ops import masked_fused as jmasked
from tpunmf.solvers import mur_masked as jmur_masked
from tpunmf_torch.data import synthetic as tsynthetic
from tpunmf_torch.io import convert
from tpunmf_torch.ops import masked_fused as tmasked
from tpunmf_torch.solvers import mur_masked as tmur_masked

# tpunmf's own tolerance for these kernels against the jnp formulas
# (tests/test_masked.py:195-220)
MASKED_RTOL, MASKED_ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("which", ["w", "h"])
@pytest.mark.parametrize("mask_kind", ["binary", "weights"])
def test_plain_versions_match_pallas_kernels(mask_kind, which, dist):
    x, mask, w, h = masked_problem(17, weights=mask_kind == "weights")
    lam = 0.05 if which == "w" else 0.02
    jfn = jmasked.masked_w_update if which == "w" else jmasked.masked_h_update
    jmask = mask.astype(np.int8) if mask_kind == "binary" else mask
    want = np.asarray(jfn(*(jnp.asarray(a) for a in (x, jmask, w, h)),
                          distance_type=dist, lam=lam, bm=8, bn=8, interpret=True))
    tfn = tmasked.masked_w_update if which == "w" else tmasked.masked_h_update
    tmask = t(mask).to(torch.uint8) if mask_kind == "binary" else t(mask)
    before = tfn.launches
    got = tfn(t(x), tmask, t(w), t(h), distance_type=dist, lam=lam)
    assert tfn.launches == before  # a CPU call runs the plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=MASKED_RTOL, atol=MASKED_ATOL)
    cold = (3, slice(None)) if which == "w" else (slice(None), 5)
    if dist == "kl":  # a fully unobserved row (column) keeps its entries
        np.testing.assert_array_equal(got.numpy()[cold], (w if which == "w" else h)[cold])
    else:  # EU has no guard: the entries go to 0
        np.testing.assert_array_equal(got.numpy()[cold], 0.0)


def _recsys(seed=4, m=40, n=30, density=0.4):
    """A small movielens_like matrix in f64, its observed mask, one user
    and one item with nothing observed, and an explicit init."""
    x = tsynthetic.movielens_like(m, n, density=density, seed=seed).astype(np.float64)
    x[7, :] = 0.0
    x[:, 11] = 0.0
    rng = np.random.default_rng(seed)
    return x, x > 0, rng.random((m, 4)) + 0.1, rng.random((4, n)) + 0.1


_X, _M, _W0, _H0 = _recsys()
_WEIGHTS = np.where(_M, 0.5 + np.random.default_rng(9).random(_M.shape), 0.0)
_BASE = dict(min_iter=5, max_iter=30, tol1=1e-12, tol2=1e-12, w_init=_W0, h_init=_H0)

CASES = {
    "eu": dict(distance_type="eu"),
    "kl": dict(distance_type="kl"),
    "eu_weights_lambda": dict(distance_type="eu", mask=_WEIGHTS, lambda_w=0.1,
                              lambda_h=0.2),
    "kl_weights_lambda": dict(distance_type="kl", mask=_WEIGHTS, lambda_w=0.2,
                              lambda_h=0.05),
    # 'zero' fill: the cold item's column of x * mask is 0, where the SVD's
    # sign noise would decide 'mean''s fill
    "kl_nndsvd_zero": dict(distance_type="kl", w_init=None, h_init=None,
                           nndsvd_init=(True, "zero")),
    # negative observed data is elevated; unobserved filler is ignored
    "eu_negative_data": dict(distance_type="eu", shift=-1.5),
    "kl_converges": dict(distance_type="kl", tol2=1e-2, min_iter=3, max_iter=300),
}


def _data(case):
    x = _X + np.where(_M, case.get("shift", 0.0), -7.0)
    return x


def _kwargs(case):
    kw = {**_BASE, **{k: v for k, v in case.items() if k not in ("shift", "mask")}}
    return kw, case.get("mask", _M)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    kw, mask = _kwargs(CASES[name])
    return tpunmf.NMF(_data(CASES[name]), 4).factorize(method="mur", mask=mask, **kw)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("name", list(CASES))
def test_masked_matches_tpunmf(name, use_pallas, monkeypatch):
    if use_pallas:  # the rule sends f64 to the plain route: force the kernel route
        monkeypatch.setattr(importlib.import_module("tpunmf_torch.solvers.masked"),
                            "masked_takes", lambda x, k: True)
    kw, mask = _kwargs(CASES[name])
    want = _jax_run(name)
    model = tpunmf_torch.NMF(t(_data(CASES[name])), 4)
    got = model.factorize(method="mur", mask=t(mask), use_pallas=use_pallas, **kw)
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)
    if name == "kl_converges":
        assert 3 < got.i < 299
    np.testing.assert_allclose(model.w, np.asarray(want.w), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(model.h, np.asarray(want.h), rtol=1e-8, atol=1e-12)
    assert model.w.dtype == np.float64
    if kw["distance_type"] == "kl" and kw["w_init"] is not None:
        np.testing.assert_array_equal(model.w[7], _W0[7])  # the cold user
        np.testing.assert_array_equal(model.h[:, 11], _H0[:, 11])  # the cold item


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_plain_f32_route_stays_near_tpunmf_float64(dist):
    """50 masked iterations at 300 x 277 k37 with a 30% mask: the port's
    plain f32 route within PLAIN_F64_RTOL of tpunmf's float64 trace at
    every iteration, the yardstick of chip_smoke.py's float64 gate."""
    rng = np.random.default_rng(7)
    m, n, k = 300, 277, 37
    x = rng.random((m, k)) @ rng.random((k, n)) + 0.05
    mask = rng.random((m, n)) < 0.3
    w0, h0 = rng.random((m, k)) + 0.1, rng.random((k, n)) + 0.1
    kw = dict(method="mur", distance_type=dist, **F64_RUN)
    want = tpunmf.NMF(x, k).factorize(mask=mask, w_init=w0, h_init=h0, **kw).obj_history
    xt, wt, ht = f32(x, w0, h0)
    got = tpunmf_torch.NMF(xt, k).factorize(mask=t(mask), w_init=wt, h_init=ht,
                                            use_pallas=False, **kw).obj_history
    assert f64_distance(got, want) <= PLAIN_F64_RTOL


def test_kernel_route_gets_a_byte_mask_and_f32_factors(monkeypatch):
    """Kernel route: a binary mask rides as uint8, a weight mask keeps X's
    dtype, and bf16 X gets f32 factors (tpunmf/solvers/masked.py:183-198)."""
    port = importlib.import_module("tpunmf_torch.solvers.masked")
    seen = []

    def spy(fn):
        def wrapper(x, mask, w, h, **kw):
            seen.append((x.dtype, mask.dtype, w.dtype, h.dtype))
            return fn(x, mask, w, h, **kw)
        return wrapper

    monkeypatch.setattr(port, "masked_w_update", spy(port.masked_w_update))
    kw = dict(distance_type="eu", max_iter=2)
    x32 = t(_X).float()
    tmur_masked(x32, t(_M), 4, use_pallas=True, **kw)
    tmur_masked(x32, t(_WEIGHTS), 4, use_pallas=True, **kw)
    tmur_masked(x32.bfloat16(), t(_M), 4, use_pallas=True, **kw)
    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    assert seen == [(f32, u8, f32, f32)] * 2 + [(f32, f32, f32, f32)] * 2 + \
        [(bf16, u8, f32, f32)] * 2
    res = tmur_masked(x32.bfloat16(), t(_M), 4, use_pallas=False, **kw)
    assert res.w.dtype == np.float32  # bf16 factors, returned as f32 numpy


def test_masked_errors_and_facade(tmp_path):
    x = t(_X)
    with pytest.raises(ValueError, match="requires a mask"):
        tmur_masked(x, None, 4)
    with pytest.raises(ValueError, match="mask shape"):
        tmur_masked(x, t(_M[:-1]), 4)
    with pytest.raises(KeyError):
        tmur_masked(x, t(_M), 4, distance_type="is")
    # checkpoints are ported: an unmasked run's checkpoint is refused (the
    # masked tag, tpunmf/solvers/masked.py:212)
    ck = str(tmp_path / "ckpt")
    tpunmf_torch.solvers.mur(x, 4, max_iter=3, checkpoint_path=ck)
    with pytest.raises(ValueError, match="configuration mismatch"):
        tmur_masked(x, t(_M), 4, max_iter=3, checkpoint_path=ck, resume=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpunmf_torch.NMF(x, 4).factorize(method="mur", mask=t(_M), beta=1.0)
    kw = dict(distance_type="kl", max_iter=4, nndsvd_init=(True, "zero"))
    jm = tpunmf.NMF(_X, 4)
    jm.factorize(method="mur", mask=_M, **kw)
    tm = tpunmf_torch.NMF(x, 4)
    tm.factorize(method="mur", mask=t(_M), **kw)
    assert tm.default_save_name() == jm.default_save_name()
    path = tm.save_factorization(save_dir=str(tmp_path))
    loaded = tpunmf_torch.NMF.load_factorization(path)
    np.testing.assert_array_equal(loaded.h, tm.h)
    assert loaded.results.obj_history == tm.results.obj_history


@pytest.mark.parametrize("dtype", [np.bool_, np.int8])
def test_convert_carries_a_masked_run_and_its_mask(dtype):
    jres = jmur_masked(_X, _M.astype(dtype), 4, distance_type="eu", max_iter=3,
                       w_init=_W0, h_init=_H0)
    tres = convert.results_to_torch(jres, dtype=torch.float64)
    mask = convert.to_tensor(_M.astype(dtype))
    assert mask.dtype == {np.bool_: torch.bool, np.int8: torch.int8}[dtype]
    got = tmur_masked(t(_X), mask, 4, distance_type="eu", max_iter=3,
                      w_init=_W0, h_init=_H0)
    assert_traces_match(got.obj_history, jres.obj_history)
    np.testing.assert_allclose(got.w, tres.w.numpy(), rtol=1e-8)
    assert convert.results_to_numpy(tres).experiment == jres.experiment


def test_movielens_like_is_tpunmf_s():
    np.testing.assert_array_equal(tsynthetic.movielens_like(30, 20, density=0.3, seed=2),
                                  jsynthetic.movielens_like(30, 20, density=0.3, seed=2))


@pytest.mark.parametrize("m,n,k", [(69878, 10677, 64), (6040, 3706, 64), (130, 70, 1),
                                   (130, 70, 1024), (300, 277, 37), (64, 24, 4),
                                   (1000, 777, 513)])
def test_row_splits_cover_every_row_once(m, n, k):
    """The H pass's row splits: whole 64-row tiles, every row of X in
    exactly one split, none empty; at MovieLens-10M's shape at least 4
    blocks for each of an H100's 132 SMs."""
    splits = tmasked.row_splits(m, n, k)
    ranges = tmasked.split_ranges(m, splits)
    assert len(ranges) == splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c and a % tmasked.H_TILE == 0 and a < b
    assert sum(b - a for a, b in ranges) == m
    # any count of splits cuts the rows the same way, the last ones short or empty
    uneven = tmasked.split_ranges(m, splits + 1)
    assert sum(b - a for a, b in uneven) == m and uneven[-1][1] == m
    blocks = -(-n // tmasked.H_TILE) * splits * -(-k // tmasked.H_TILE)
    if (m, n) == (69878, 10677):
        assert blocks >= 4 * 132


@pytest.mark.parametrize("m,k,rows", [(69878, 64, 64), (6040, 64, 32), (6040, 256, 64),
                                      (130, 1024, 32), (16833, 64, 64), (16832, 64, 32)])
def test_w_block_rows_fill_a_wave(m, k, rows):
    """The W pass's block rows: 64 where ceil(m / 64) x ceil(k / 64) blocks
    fill one wave of two blocks on each of an H100's 132 SMs (264), else 32:
    MovieLens-10M at k 64 has 1092 blocks of 64; MovieLens-1M (6040 rows)
    95 at k 64 (so 32) and 380 at k 256; 16833 rows make 264 tiles, 16832 263."""
    assert tmasked.w_block_rows(m, k) == rows


@pytest.mark.parametrize("n,stride", [(10677, 10680), (3706, 3708), (277, 280), (260, 260),
                                      (1, 4), (4, 4)])
def test_h_stride_starts_every_row_of_h_on_16_bytes(n, stride):
    """The row stride of the W pass's H: n rounded up to 4 floats."""
    assert tmasked.h_stride(n) == stride
