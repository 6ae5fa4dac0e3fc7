"""tpunmf_torch's N-way CP (``ntf``) against tpunmf's, on the CPU at float64.

MTTKRP and the reconstruction per mode; every update family (MUR EU,
CP-HALS on both routes, KL, masked EU and KL, per-mode lambdas, normalize
off) at a 3-way, a 4-way and a 2-way tensor from one ``factors_init``
(torch cannot draw jax.random's numbers); every validation with tpunmf's
message; the facade, its refusals and its files both ways; the rank scan's
fields; the factor list carried across the packages.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import assert_traces_match, t
from tpunmf.experiments import ntf_rank_scan as jntf_rank_scan
from tpunmf.solvers import cp_reconstruct as jcp_reconstruct
from tpunmf.solvers import mttkrp as jmttkrp
from tpunmf.solvers import ntf as jntf
from tpunmf_torch.experiments import ntf_rank_scan
from tpunmf_torch.io import convert
from tpunmf_torch.solvers import NtfResults, cp_reconstruct, mttkrp, ntf

ntf_module = importlib.import_module("tpunmf_torch.solvers.ntf")

# factors of the two packages at f64: the same formulas, sums in another order
FACTOR_RTOL = 1e-8
SHAPES = {"3way": ((8, 7, 6), 3), "4way": ((5, 4, 4, 3), 2), "2way": ((9, 6), 3)}


def _problem(name, seed=0):
    """(x, factors_init, mask) numpy: a CP model of uniform + 0.1 factors
    plus noise, a second draw as init, and a 70% observation mask."""
    shape, k = SHAPES[name]
    rng = np.random.default_rng(seed)
    fs = [rng.random((d, k)) + 0.1 for d in shape]
    x = np.asarray(jcp_reconstruct([jnp.asarray(f) for f in fs])) + 0.05 * rng.random(shape)
    init = [rng.random((d, k)) + 0.1 for d in shape]
    mask = (rng.random(shape) < 0.7).astype(np.float64)
    return x, init, mask


def _assert_ntf_match(got, want):
    assert isinstance(got, NtfResults)
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)
    assert len(got.factors) == len(want.factors)
    for a, b in zip(got.factors, want.factors):
        b = np.asarray(b)
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=FACTOR_RTOL, atol=FACTOR_RTOL * np.abs(b).max())
    assert tuple(got.experiment) == tuple(want.experiment)
    assert repr(got.experiment) == repr(want.experiment)


@pytest.mark.parametrize("name", list(SHAPES))
def test_mttkrp_and_cp_reconstruct_are_tpunmf_s(name):
    x, fs, _ = _problem(name)
    tfs = [t(f) for f in fs]
    for mode in range(x.ndim):
        want = np.asarray(jmttkrp(jnp.asarray(x), [jnp.asarray(f) for f in fs], mode))
        got = mttkrp(t(x), tfs, mode)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(cp_reconstruct(tfs).numpy(),
                               np.asarray(jcp_reconstruct([jnp.asarray(f) for f in fs])),
                               rtol=1e-12)


_CONFIGS = {
    "mur_eu": dict(),
    "hals": dict(update="hals"),
    # the sweep kernel's wiring: gs_sweep(M^T, G, F^T) (its plain version on the CPU)
    "hals_kernel_route": dict(update="hals", use_pallas=True),
    "kl": dict(distance_type="kl"),
    "masked_eu": dict(mask=True),
    "masked_kl": dict(mask=True, distance_type="kl"),
    "lambdas": dict(lambdas=True),
    "hals_lambdas_no_normalize": dict(update="hals", lambdas=True, normalize=False),
    "no_normalize": dict(normalize=False),
}
_CASES = ([("3way", c) for c in _CONFIGS]
          + [("4way", c) for c in ("mur_eu", "hals", "kl", "masked_eu")]
          + [("2way", c) for c in ("mur_eu", "hals_kernel_route", "kl")])


@pytest.mark.parametrize("name,config", _CASES)
def test_ntf_matches_tpunmf(name, config, monkeypatch):
    x, init, mask = _problem(name)
    kw = dict(_CONFIGS[config])
    if kw.pop("use_pallas", False):
        calls = []
        monkeypatch.setattr(ntf_module, "sweep_takes", lambda x, k: True)
        monkeypatch.setattr(ntf_module, "gs_sweep",
                            lambda *a, **k: calls.append(1) or ntf_module.gs_sweep_ref(*a, **k))
    if kw.get("lambdas"):
        kw["lambdas"] = [0.1 * (d + 1) for d in range(x.ndim)]
    base = dict(min_iter=12, max_iter=12, tol1=0.0, tol2=0.0, factors_init=init)
    want = jntf(x, SHAPES[name][1], **base, **{**kw, **({"mask": mask} if "mask" in kw else {})})
    got = ntf(t(x), SHAPES[name][1], **base, use_pallas=config == "hals_kernel_route",
              **{**kw, **({"mask": t(mask)} if "mask" in kw else {})})
    assert got.i == 11
    _assert_ntf_match(got, want)
    if config == "hals_kernel_route":
        assert len(calls) == x.ndim * 12


_X_ERR, _INIT_ERR, _ = _problem("3way")
_NEG = _X_ERR.copy()
_NEG[0, 0, 0] = -1.0
_BAD_INIT = [f.copy() for f in _INIT_ERR]
_BAD_INIT[1][0, 0] = -1.0
_ERRORS = {
    "one_way": (np.ones(5), {}),
    "distance": (_X_ERR, dict(distance_type="is")),
    "update": (_X_ERR, dict(update="als")),
    "kl_hals": (_X_ERR, dict(distance_type="kl", update="hals")),
    "negative_x": (_NEG, {}),
    "mask_hals": (_X_ERR, dict(update="hals", mask=np.ones(_X_ERR.shape))),
    "mask_shape": (_X_ERR, dict(mask=np.ones((8, 7)))),
    "mask_negative": (_X_ERR, dict(mask=-np.ones(_X_ERR.shape))),
    "lambdas_length": (_X_ERR, dict(lambdas=[0.1, 0.1])),
    "lambdas_kl": (_X_ERR, dict(distance_type="kl", lambdas=[0.0, 0.1, 0.0])),
    "init_length": (_X_ERR, dict(factors_init=_INIT_ERR[:2])),
    "init_shape": (_X_ERR, dict(factors_init=[_INIT_ERR[0][:, :2]] + _INIT_ERR[1:])),
    "init_negative": (_X_ERR, dict(factors_init=_BAD_INIT)),
    "21_modes": (np.ones((1,) * 21), {}),
}


@pytest.mark.parametrize("case", list(_ERRORS))
def test_validation_errors_are_tpunmf_s(case):
    x, kw = _ERRORS[case]
    with pytest.raises(ValueError) as want:
        jntf(x, 3, max_iter=2, **kw)
    tkw = {n: (t(v) if n == "mask" else v) for n, v in kw.items()}
    with pytest.raises(ValueError) as got:
        ntf(t(x), 3, max_iter=2, **tkw)
    assert str(got.value) == str(want.value)


def test_random_init_is_seeded_and_scaled():
    x, _, _ = _problem("3way")
    a = ntf(t(x), 3, min_iter=1, max_iter=1)                 # key None: seed 42
    b = ntf(t(x), 3, min_iter=1, max_iter=1, key=42)
    c = ntf(t(x), 3, min_iter=1, max_iter=1, key=torch.Generator().manual_seed(42))
    d = ntf(t(x), 3, min_iter=1, max_iter=1, key=7)
    assert a.obj_history == b.obj_history == c.obj_history != d.obj_history
    # |N(0,1)| * (mean(X)/k + 1e-9)^(1/3) per mode: the model's scale is X's
    g = torch.Generator().manual_seed(42)
    scale = (x.mean() / 3 + 1e-9) ** (1 / 3)
    init = [torch.randn((n, 3), generator=g, dtype=torch.float64).abs() * scale
            for n in x.shape]
    e = ntf(t(x), 3, min_iter=1, max_iter=1, factors_init=init)
    assert a.obj_history == e.obj_history


def test_facade_runs_ntf_as_tpunmf_does(tmp_path):
    x, init, _ = _problem("3way")
    kw = dict(update="hals", factors_init=init, min_iter=8, max_iter=8, tol1=0.0, tol2=0.0)
    jm = tpunmf.NMF(x, 3)
    jf = jm.fit_transform(method="ntf", **kw)
    tm = tpunmf_torch.NMF(t(x), 3)
    tf = tm.fit_transform(method="ntf", **kw)
    _assert_ntf_match(tm.results, jm.results)
    np.testing.assert_array_equal(tf, tm.results.factors[0])
    np.testing.assert_allclose(tf, np.asarray(jf), rtol=FACTOR_RTOL)
    assert tm.w is None and tm.h is None and tm.components_ is None
    assert tm.default_save_name() == jm.default_save_name() == "ntf_3_eu_hals_8x7x6"
    for call in (lambda m: m.transform(x[:, :, 0]), lambda m: m.inverse_transform(x[0])):
        with pytest.raises(RuntimeError) as want:
            call(jm)
        with pytest.raises(RuntimeError) as got:
            call(tm)
        assert str(got.value) == str(want.value) and "N-way CP" in str(got.value)


@pytest.mark.parametrize("direction", ["tpunmf_to_port", "port_to_tpunmf"])
def test_ntf_files_cross_between_packages(tmp_path, direction):
    x, init, _ = _problem("4way")
    kw = dict(distance_type="kl", factors_init=init, min_iter=5, max_iter=5)
    jm, tm = tpunmf.NMF(x, 2), tpunmf_torch.NMF(t(x), 2)
    jm.factorize(method="ntf", **kw)
    tm.factorize(method="ntf", **kw)
    writer, reader = ((jm, tpunmf_torch.NMF) if direction == "tpunmf_to_port"
                      else (tm, tpunmf.NMF))
    path = writer.save_factorization(save_dir=str(tmp_path))
    assert path.endswith("ntf_2_kl_mur_5x4x4x3.npz")
    back = reader.load_factorization(path)
    assert type(back.results).__name__ == "NtfResults" and back.w is None
    for a, b in zip(back.results.factors, writer.results.factors):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert back.results.i == writer.results.i
    np.testing.assert_array_equal(back.results.obj_history, writer.results.obj_history)
    assert back.results.experiment._asdict() == writer.results.experiment._asdict()
    assert back.default_save_name() == writer.default_save_name()
    again = back.save_factorization(save_dir=str(tmp_path / "again"))
    with np.load(path, allow_pickle=True) as f, np.load(again, allow_pickle=True) as g:
        assert sorted(f.files) == sorted(g.files)
        assert all(f[k].dtype == g[k].dtype for k in f.files)


def test_ntf_rank_scan_fields():
    x, _, _ = _problem("3way")
    want = jntf_rank_scan(x, [3], n_iter=15)
    got = ntf_rank_scan(t(x), [2, 3], n_iter=15)
    assert all(sorted(r) == sorted(want[0]) for r in got)
    assert [r["k"] for r in got] == [2, 3]
    assert all(type(v) is type(want[0][n]) for r in got for n, v in r.items())
    # the planted rank fits better than one below it
    assert got[1]["rel_err"] < got[0]["rel_err"]
    # rank ks[i]'s fit: its final objective from the generator of (key, i)
    from tpunmf_torch.experiments import _rank_seed

    g = torch.Generator().manual_seed(_rank_seed(None, 1))
    res = ntf(t(x), 3, update="hals", max_iter=15, min_iter=10, tol1=1e-9, tol2=1e-9, key=g)
    assert got[1]["final_obj"] == float(res.obj_history[-1])


def test_ntf_results_cross_as_tensors_and_back():
    x, init, _ = _problem("3way")
    want = jntf(x, 3, factors_init=init, min_iter=3, max_iter=3)
    on_torch = convert.ntf_results_to_torch(want, dtype=torch.float64)
    assert all(isinstance(f, torch.Tensor) and f.dtype == torch.float64
               for f in on_torch.factors)
    back = convert.ntf_results_to_numpy(on_torch)
    for a, b in zip(back.factors, want.factors):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert back.i == want.i and back.experiment == want.experiment
