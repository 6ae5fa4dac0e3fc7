"""tpunmf_torch's tri-factorization (NMTF) against tpunmf's, on the CPU at
float64.

From explicit F, S, G (torch cannot draw jax.random's numbers) at two
shapes and on mixed-sign X (elevated as tpunmf elevates it); Lloyd's part
of the k-means init from seed indices drawn by ``jax.random.choice``, on
rows and on columns, its distances over chunks of points; the default init
drawn from a seeded generator; the objective kernel's wiring; the errors;
checkpoints across the packages.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_results_match, lowrank, run_interrupted, t
from tpunmf.solvers import nmtf as jnmtf
from tpunmf.solvers.nmtf import _kmeans_indicator as jkmeans
from tpunmf_torch.solvers import nmtf

nmtf_module = importlib.import_module("tpunmf_torch.solvers.nmtf")

FACTOR_RTOL = 1e-8
_KW = dict(min_iter=25, max_iter=25, tol1=0.0, tol2=0.0)
_X = lowrank(m=40, n=30)


def _inits(m, n, kr=3, kc=4, seed=11):
    rng = np.random.default_rng(seed)
    return dict(f_init=rng.random((m, kr)) + 0.2, s_init=rng.random((kr, kc)) + 0.2,
                g_init=rng.random((n, kc)) + 0.2)


@pytest.mark.parametrize("case", ["40x30", "30x50", "mixed_sign"])
def test_nmtf_matches_tpunmf(case):
    x = {"40x30": _X, "30x50": lowrank(m=30, n=50), "mixed_sign": _X - 0.5}[case]
    kw = dict(_KW, **_inits(*x.shape))
    want, want_s = jnmtf(x, 3, 4, **kw)
    got, got_s = nmtf(t(x), 3, 4, **kw)
    assert got.i == 24 and got.w.shape == (x.shape[0], 3) and got.h.shape == (4, x.shape[1])
    assert_results_match(got, want, FACTOR_RTOL)
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=FACTOR_RTOL)


@pytest.mark.parametrize("axis", ["rows", "columns"])
@pytest.mark.parametrize("chunk_bytes", [1 << 28, 8 * 4 * 30 * 3])
def test_lloyd_s_part_from_tpunmf_s_seeds(axis, chunk_bytes, monkeypatch):
    """jax.random.choice draws the seed points; both packages run Lloyd's
    from them (the port's distances over chunks of a few points too)."""
    monkeypatch.setattr(nmtf_module, "_KMEANS_CHUNK_BYTES", chunk_bytes)
    xt = _X if axis == "rows" else np.ascontiguousarray(_X.T)
    k = 4
    key = jax.random.PRNGKey(3)
    idx = np.array(jax.random.choice(key, xt.shape[0], (k,), replace=False))
    want = np.asarray(jkmeans(jnp.asarray(xt), k, key))
    got = nmtf_module._kmeans_indicator(t(xt), k, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0.2, 1.2}


def test_default_init_draws_its_seeds_from_the_generator():
    """key=None is seed 0: the seed points come from one generator, rows
    first; S is the closed form F^T X G over the cluster sizes."""
    res, s = nmtf(t(_X), 3, 4, min_iter=1, max_iter=1)
    g = torch.Generator().manual_seed(0)
    x = t(_X)
    f = nmtf_module._kmeans_indicator(x, 3, nmtf_module._seed_points(40, 3, g))
    gg = nmtf_module._kmeans_indicator(x.T.contiguous(), 4, nmtf_module._seed_points(30, 4, g))
    s0 = f.T @ x @ gg / (f.sum(dim=0)[:, None] * gg.sum(dim=0)[None, :])
    again, s_again = nmtf(t(_X), 3, 4, min_iter=1, max_iter=1, f_init=f, s_init=s0, g_init=gg)
    assert_results_match(res, again, 0)
    np.testing.assert_array_equal(s, s_again)


def test_objective_kernel_is_called_once_an_iteration(monkeypatch):
    """Float32 X with use_pallas: the objective goes through
    eu_residual_obj(X, F, S G^T) (its plain version on the CPU), once for
    obj[0] and once an iteration, and the factors are the plain route's."""
    calls = []
    monkeypatch.setattr(nmtf_module, "eu_residual_obj",
                        lambda *a: calls.append(1) or nmtf_module.eu_residual_obj_ref(*a))
    kw = dict(min_iter=5, max_iter=5, **_inits(40, 30))
    got, s = nmtf(t(_X).float(), 3, 4, use_pallas=True, **kw)
    plain, s_plain = nmtf(t(_X).float(), 3, 4, use_pallas=False, **kw)
    assert len(calls) == 6
    assert_results_match(got, plain, 0)
    np.testing.assert_array_equal(s, s_plain)


def test_partial_inits_are_refused_as_tpunmf_does():
    kw = _inits(40, 30)
    del kw["s_init"]
    with pytest.raises(ValueError) as want:
        jnmtf(_X, 3, 4, **kw)
    with pytest.raises(ValueError) as got:
        nmtf(t(_X), 3, 4, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("direction", ["tpunmf_to_port", "port_to_tpunmf"])
def test_checkpoint_crosses_between_packages(tmp_path, direction):
    kw = dict(_KW, **_inits(40, 30))
    want, want_s = jnmtf(_X, 3, 4, **kw)
    writer, reader = ((jnmtf, nmtf) if direction == "tpunmf_to_port" else (nmtf, jnmtf))
    data = {jnmtf: _X, nmtf: t(_X)}
    ck = str(tmp_path / "nmtf")
    run_interrupted(lambda **c: writer(data[writer], 3, 4, **kw, **c), ck, 10, 2)
    got, got_s = reader(data[reader], 3, 4, checkpoint_path=ck, checkpoint_every=10,
                        resume=True, **kw)
    assert_results_match(got, want, FACTOR_RTOL)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=FACTOR_RTOL)
