"""tpunmf_torch ops: plain versions vs tpunmf's Pallas kernels (interpret
mode on the CPU), the wrappers' dispatch and checks, and the kernel build.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
compares them with their plain versions there.
"""
import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import KERNEL_RTOL, SUM_RTOL, kernel_problem, t
from tpunmf.core import losses as jlosses
from tpunmf.ops import fused as jfused
from tpunmf.ops import mur_fused as jmur_fused
from tpunmf_torch.core import losses as tlosses
from tpunmf_torch.ops import _build, _launch
from tpunmf_torch.ops import fused as tfused
from tpunmf_torch.ops import mur_fused as tmur_fused

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
    np.testing.assert_allclose(tfused.kl_ratio(t(x), t(w), t(h)).numpy(),
                               np.asarray(jr), rtol=1e-14)


def test_gram_objective_matches_tpunmf():
    x, w, h = (a.astype(np.float64) for a in kernel_problem(8))
    xsq, wtx, gw = (x * x).sum(), w.T @ x, w.T @ w
    want = float(jlosses.eu_objective_gram(xsq, jnp.asarray(wtx), jnp.asarray(gw),
                                           jnp.asarray(h)))
    got = float(tlosses.eu_objective_gram(torch.tensor(xsq), t(wtx), t(gw), t(h)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, 0.5 * ((x - w @ h) ** 2).sum(), rtol=1e-10)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    x, w, h = kernel_problem(9)
    wrappers = (tmur_fused.mur_w_update, tmur_fused.mur_h_update,
                tfused.eu_residual_obj, tfused.kl_obj)
    before = [fn.launches for fn in wrappers]
    got = tmur_fused.mur_w_update(t(x), t(w), t(h), distance_type="kl", lam=0.1)
    want = tmur_fused.mur_w_update_ref(t(x), t(w), t(h), distance_type="kl", lam=0.1)
    assert torch.equal(got, want)
    tmur_fused.mur_h_update(t(x), t(w), t(h), distance_type="eu", lam=0.0)
    tfused.eu_residual_obj(t(x), t(w), t(h))
    tfused.kl_obj(t(x), t(w), t(h))
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
        _launch.check_operands("k", x, w, h)
    assert _launch.check_operands("k", *(t(a) for a in kernel_problem(11, m=8, n=12, k=3))) == (8, 12, 3)


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
        assert all(a in (ctypes.c_void_p, ctypes.c_int, ctypes.c_float)
                   for a in argtypes)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _build.check(2, "tpunmf_objective")
