"""tpunmf_torch's online NMF against tpunmf's, on the CPU at float64.

Ragged minibatches (zero-padded to the widest seen) with rho 1 and rho < 1,
from one W (torch cannot draw jax.random's numbers): each encode, W after
each minibatch and the mixed-iterate objectives; the sweep kernel's wiring;
``online_nmf``; ``transform``; the errors; the device rule; the stream
state carried from tpunmf to the port mid-stream.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lowrank, t
from tpunmf.solvers import OnlineNMF as JOnlineNMF
from tpunmf.solvers import online_nmf as jonline_nmf
from tpunmf_torch.io import convert
from tpunmf_torch.solvers import OnlineNMF, online_nmf

online_module = importlib.import_module("tpunmf_torch.solvers.online")

FACTOR_RTOL = 1e-8
_X = lowrank(m=40, n=30)
_W0 = np.random.default_rng(13).random((40, 4)) + 0.1
# ragged: the third and fourth batches are narrower than the widest seen
_BATCHES = [_X[:, :8], _X[:, 8:17], _X[:, 17:21], _X[:, 21:28], _X[:, 28:]]


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=FACTOR_RTOL, atol=FACTOR_RTOL * np.abs(b).max())


@pytest.mark.parametrize("rho,sweeps,kernel", [(1.0, 2, False), (0.7, 2, False),
                                               (0.9, 1, True)],
                         ids=["rho1", "rho0.7", "kernel_route"])
def test_online_nmf_matches_tpunmf(rho, sweeps, kernel, monkeypatch):
    calls = []
    if kernel:
        # the sweep kernel's wiring: gs_sweep(B^T, A, W^T) (its plain version here)
        monkeypatch.setattr(online_module, "sweep_takes", lambda x, k: True)
        monkeypatch.setattr(online_module, "gs_sweep", lambda *a, **k: calls.append(k)
                            or online_module.gs_sweep_ref(*a, **k))
    jm = JOnlineNMF(40, 4, rho=rho, sweeps=sweeps, w_init=_W0, dtype=jnp.float64)
    tm = OnlineNMF(40, 4, rho=rho, sweeps=sweeps, w_init=t(_W0), dtype=torch.float64,
                   use_pallas=kernel)
    for b in _BATCHES:
        hj, ht = jm.partial_fit(b), tm.partial_fit(t(b))
        assert isinstance(ht, torch.Tensor) and ht.shape == (4, b.shape[1])
        _close(ht.numpy(), hj)
        _close(tm.w, jm.w)
    assert tm.n_batches == jm.n_batches == 5 and tm._batch_width == jm._batch_width == 9
    np.testing.assert_allclose(tm.obj_history, jm.obj_history, rtol=1e-10)
    if kernel:
        assert calls == [dict(lam=0.0, nsweeps=sweeps)] * 5


def test_online_nmf_over_batches_and_transform():
    jm = jonline_nmf(_BATCHES, 40, 4, w_init=_W0, dtype=jnp.float64, track_objective=False)
    tm = online_nmf([t(b) for b in _BATCHES], 40, 4, w_init=t(_W0), dtype=torch.float64,
                    track_objective=False)
    assert tm.obj_history == jm.obj_history == []
    _close(tm.w, jm.w)
    _close(tm.transform(t(_X)).numpy(), jm.transform(_X))


def test_default_init_is_seeded():
    a = OnlineNMF(40, 4, device="cpu", dtype=torch.float64)
    b = OnlineNMF(40, 4, device="cpu", dtype=torch.float64, key=0)
    g = torch.Generator().manual_seed(0)
    want = torch.randn((40, 4), generator=g, dtype=torch.float64).abs()
    np.testing.assert_array_equal(a.w, want.numpy())
    np.testing.assert_array_equal(a.w, b.w)
    assert a.w.dtype == np.float64


def test_the_state_lives_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default state goes there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        OnlineNMF(40, 4)
    with pytest.raises(RuntimeError, match="CUDA device"):
        OnlineNMF(40, 4, w_init=_W0)
    model = OnlineNMF(40, 4, w_init=t(_W0))  # a CPU tensor: the CPU, in float32
    assert model._w.device.type == "cpu" and model._w.dtype == torch.float32
    h = model.partial_fit(_X[:, :5])  # numpy minibatches follow the state
    assert h.device.type == "cpu" and h.dtype == torch.float32


@pytest.mark.parametrize("case", ["rho", "w_init", "minibatch"])
def test_errors_are_tpunmf_s(case):
    def make(pkg_cls, w0, **kw):
        return pkg_cls(40, 4, w_init=w0, **kw)

    if case == "rho":
        calls = [lambda: make(JOnlineNMF, _W0, rho=0.0),
                 lambda: make(OnlineNMF, t(_W0), rho=0.0)]
    elif case == "w_init":
        calls = [lambda: JOnlineNMF(40, 4, w_init=_W0[:, :3]),
                 lambda: OnlineNMF(40, 4, w_init=t(_W0[:, :3]))]
    else:
        calls = [lambda: make(JOnlineNMF, _W0, dtype=jnp.float64).partial_fit(_X[:30]),
                 lambda: make(OnlineNMF, t(_W0)).partial_fit(t(_X[:30]))]
    with pytest.raises(ValueError) as want:
        calls[0]()
    with pytest.raises(ValueError) as got:
        calls[1]()
    assert str(got.value) == str(want.value)


def test_stream_state_crosses_from_tpunmf_mid_stream():
    """Two minibatches in tpunmf, the state carried to the port (and back
    to numpy unchanged), the rest of the stream in both."""
    jm = JOnlineNMF(40, 4, rho=0.8, w_init=_W0, dtype=jnp.float64)
    for b in _BATCHES[:2]:
        jm.partial_fit(b)
    state = convert.online_state(jm)
    assert state["n_batches"] == 2 and state["batch_width"] == 9
    tm = OnlineNMF(40, 4, rho=0.8, w_init=t(np.zeros((40, 4))), dtype=torch.float64)
    convert.set_online_state(tm, state)
    back = convert.online_state(tm)
    for name in ("w", "a", "b"):
        np.testing.assert_array_equal(back[name], state[name])
    assert (back["n_batches"], back["batch_width"]) == (2, 9)
    for b in _BATCHES[2:]:
        _close(tm.partial_fit(t(b)).numpy(), jm.partial_fit(b))
    _close(tm.w, jm.w)
    assert tm.n_batches == jm.n_batches == 5
