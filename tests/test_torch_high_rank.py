"""The route rule for every dtype and rank, and MUR's high-rank step.

The port's route function and kernel-family predicates are held against
``tpunmf``'s predicates on ``meta`` tensors; MUR's high-rank step (the jnp
step with the ratio and objective kernels, tpunmf/solvers/mur.py:242-280)
against ``tpunmf``'s at float64, iterate for iterate.  float64 takes the
plain route by rule, so the parity tests force the high-rank step, as the
single-pass tests force the single pass.  The kernels themselves run only
on the card (tests/test_torch_cuda.py).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_traces_match, lowrank, t
from tpunmf.ops import fused as jfused
from tpunmf.ops import hals_sweep as jhals_sweep
from tpunmf.ops import masked_fused as jmasked_fused
from tpunmf.ops import mur_fused as jmur_fused
from tpunmf.solvers import mur as jmur
from tpunmf_torch.core.device import as_input
from tpunmf_torch.ops import fused, hals_sweep, masked_fused, mur_fused
from tpunmf_torch.solvers import mur

port_mur = importlib.import_module("tpunmf_torch.solvers.mur")

# the path's shape (tpunmf's own route-test shape) and a ragged one
SHAPES = [(8192, 4096), (1000, 777)]
RANKS = (1, 128, 1024, 1025, 1536, 2048, 2049)
DTYPES = ("float32", "bfloat16", "float64")


def _meta_and_spec(shape, dtype):
    return (torch.empty(shape, dtype=getattr(torch, dtype), device="meta"),
            jax.ShapeDtypeStruct(shape, getattr(jnp, dtype)))


@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_mur_route_follows_tpunmf(shape, dtype, k, dist):
    """The single pass exactly where tpunmf's iter_*_tileable give strips;
    the high-rank step for f32/bf16 at 1024 < k <= 2048 (wherever tpunmf
    takes its own); the plain route for f64 and k > 2048; the 2-pass pair
    elsewhere (wherever tpunmf's mur_tileable gives a tile)."""
    meta, spec = _meta_and_spec(shape, dtype)
    tileable = jmur_fused.iter_eu_tileable if dist == "eu" else jmur_fused.iter_kl_tileable
    strips = tileable(spec, k)
    route = port_mur.mur_route(meta, k, dist)
    if strips is not None:
        assert route == ("single", strips)
    elif dtype == "float64" or k > 2048:
        assert route == ("plain", None)
    elif k > 1024:
        assert route == ("high_rank", None)
    else:
        assert route == ("pair", None)
    if jmur_fused.mur_tileable(spec, k) is not None:
        assert route[0] in ("single", "pair")
    # tpunmf's high-rank step (no update kernel, the objective kernels tile)
    # above 1024; at or below it, where only tpunmf's VMEM budget refuses
    # the update kernels (8192x4096 at k = 1024), the port takes the pair
    w = jax.ShapeDtypeStruct((shape[0], k), jnp.float32)
    h = jax.ShapeDtypeStruct((k, shape[1]), jnp.float32)
    if k > 1024 and jmur_fused.mur_tileable(spec, k) is None \
            and jfused._tileable(spec, w, h) is not None:
        assert route[0] == "high_rank"
    assert port_mur.mur_route(meta, k, dist, use_pallas=False) == ("plain", None)


@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_families_take_what_tpunmf_s_kernels_take(shape, dtype, k):
    """Each family's predicate is a rule of dtype and rank; wherever
    tpunmf's own predicate gives a tile, the family takes X; above
    tpunmf's rank cuts both refuse (the port also takes ragged shapes and,
    for the objectives, bf16 X and 2048 beyond the VMEM budget: ROADMAP's
    known differences)."""
    meta, spec = _meta_and_spec(shape, dtype)
    m, n = shape
    wide = dtype != "float64"
    assert fused.objective_takes(meta, k) == (wide and k <= 2048)
    assert mur_fused.updates_take(meta, k) == (wide and k <= 1024)
    assert masked_fused.masked_takes(meta, k) == (wide and k <= 1024)
    assert hals_sweep.sweep_takes(meta, k) == (dtype == "float32" and k <= 1024)
    w = jax.ShapeDtypeStruct((m, k), jnp.float32)
    h = jax.ShapeDtypeStruct((k, n), jnp.float32)
    tpunmf_takes = {
        "objective": jfused._tileable(spec, w, h) is not None,
        "updates": jmur_fused.mur_tileable(spec, k) is not None,
        "masked": jmasked_fused.masked_tileable(spec, k) is not None,
        "sweep": (dtype == "float32" and jhals_sweep.gs_sweep_tileable(k, m) is not None
                  and jhals_sweep.gs_sweep_tileable(k, n) is not None),
    }
    port_takes = {"objective": fused.objective_takes(meta, k),
                  "updates": mur_fused.updates_take(meta, k),
                  "masked": masked_fused.masked_takes(meta, k),
                  "sweep": hals_sweep.sweep_takes(meta, k)}
    for family, takes in tpunmf_takes.items():
        assert port_takes[family] or not takes, family
    if k > 2048:
        assert not tpunmf_takes["objective"]
    if k > 1024:
        assert not (tpunmf_takes["updates"] or tpunmf_takes["masked"])


# the high-rank step at f64 against tpunmf's jnp step with use_pallas on
_M, _N, _K = 96, 80, 1100
_INIT = np.random.default_rng(5)
_W0 = _INIT.random((_M, _K)) / _K + 1e-3
_H0 = _INIT.random((_K, _N)) + 0.1
HIGH_RANK_CASES = [(dist, every) for dist in ("eu", "kl") for every in (1, 3)]


def _kw(dist, every):
    return dict(distance_type=dist, objective_every=every, min_iter=5, max_iter=10,
                tol1=1e-9, tol2=1e-9, w_init=_W0, h_init=_H0)


@functools.lru_cache(maxsize=None)
def _jax_run(dist, every):
    return jmur(lowrank(m=_M, n=_N), _K, use_pallas=True, **_kw(dist, every))


@pytest.mark.parametrize("dist,every", HIGH_RANK_CASES)
def test_high_rank_step_matches_tpunmf_at_f64(dist, every, monkeypatch):
    x = t(lowrank(m=_M, n=_N))
    assert port_mur.mur_route(x, _K, dist) == ("plain", None)  # the rule: f64
    calls = []
    monkeypatch.setattr(port_mur, "updates_take", lambda x, k: False)
    monkeypatch.setattr(port_mur, "objective_takes", lambda x, k: True)
    for name in ("kl_ratio", "kl_ratio_and_obj", "eu_residual_obj", "kl_ratio_ref",
                 "kl_ratio_and_obj_ref", "eu_residual_obj_ref", "mur_w_update",
                 "mur_iteration_eu", "mur_iteration_kl"):
        monkeypatch.setattr(port_mur, name, lambda *a, _fn=getattr(port_mur, name), _n=name,
                            **k: calls.append(_n) or _fn(*a, **k))
    assert port_mur.mur_route(x, _K, dist) == ("high_rank", None)
    want = _jax_run(dist, every)
    got = mur(x, _K, use_pallas=True, **_kw(dist, every))
    assert got.i == want.i == 9
    assert_traces_match(got.obj_history, want.obj_history)
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=1e-8, atol=1e-14)
    if every == 3:
        assert np.isnan(got.obj_history).sum() == 6
    iters = got.i + 1
    # real objectives: every iteration, or the refresh ones (i + 1) % 3 == 0
    # and the last possible one; plus the initial one
    real = sum((i + 1) % every == 0 or i + 1 >= 10 for i in range(iters))
    if dist == "kl":
        assert calls.count("kl_ratio") == iters + (iters - real)
        assert calls.count("kl_ratio_and_obj") == real + 1
    else:
        assert calls.count("eu_residual_obj") == real + 1
    assert set(calls) <= {"kl_ratio", "kl_ratio_and_obj", "eu_residual_obj"}


def test_high_rank_step_takes_lagged_as_exact(monkeypatch):
    """tpunmf's jnp step records the exact objective for 'lagged'."""
    monkeypatch.setattr(port_mur, "updates_take", lambda x, k: False)
    monkeypatch.setattr(port_mur, "objective_takes", lambda x, k: True)
    got = mur(t(lowrank(m=_M, n=_N)), _K, use_pallas=True, objective="lagged",
              **_kw("kl", 1))
    want = _jax_run("kl", 1)
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)


def test_high_rank_step_upcasts_bf16_x_once():
    """bf16 X at k = 1025 on the CPU takes the high-rank step with X upcast
    to f32 at setup: the trace is the plain route's, which promotes the
    same way (tpunmf's jnp products promote in every product)."""
    x = t(lowrank(m=_M, n=_N)).float().bfloat16()
    assert port_mur.mur_route(x, 1025, "kl") == ("high_rank", None)
    w0, h0 = _W0[:, :1025].astype(np.float32), _H0[:1025].astype(np.float32)
    kw = dict(distance_type="kl", min_iter=4, max_iter=4, w_init=w0, h_init=h0)
    high = mur(x, 1025, use_pallas=True, **kw)
    plain = mur(x, 1025, use_pallas=False, **kw)
    assert high.w.dtype == np.float32 and high.i == plain.i == 3
    np.testing.assert_array_equal(high.obj_history, plain.obj_history)


# ------------------------------------------------------- the input dtype rule

def test_a_cpu_destination_and_a_tensor_keep_float64():
    a = lowrank()
    assert as_input(a, device="cpu").dtype == torch.float64
    assert as_input(t(a)).dtype == torch.float64
    assert as_input(t(a), device="cpu").dtype == torch.float64
    assert as_input(a, dtype=torch.float32, device="cpu").dtype == torch.float32
    assert as_input(a.astype(np.float32), device="cpu").dtype == torch.float32
