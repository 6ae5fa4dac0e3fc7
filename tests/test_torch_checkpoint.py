"""tpunmf_torch's checkpoint/resume against tpunmf's, on the CPU at float64.

The port's versions of tests/test_checkpoint.py's npz cases; a resumed run
equals the uninterrupted one for every ported solver (W, H, ``i`` and the
trace within 1e-12); checkpoints cross between the packages in both
directions; a KL checkpoint of one MUR route kind is refused on the other.
"""
import importlib

import numpy as np
import pytest
import torch

from _torch_parity import TRACE_RTOL, assert_traces_match, lowrank, t
from tpunmf.io import checkpoint_exists as jcheckpoint_exists
from tpunmf.solvers import admm as jadmm
from tpunmf.solvers import gnmf as jgnmf
from tpunmf.solvers import mur as jmur
from tpunmf.solvers import ntf as jntf
from tpunmf_torch.io import checkpoint_exists, load_state, save_state
from tpunmf_torch.solvers import (admm, anls, ao_admm, gnmf, hals, knn_graph, mur, mur_beta,
                                  mur_masked, ntf)
from tpunmf_torch.solvers.common import init_carry

mur_module = importlib.import_module("tpunmf_torch.solvers.mur")


class _Interrupt(Exception):
    pass


def _interrupt_after(n_blocks):
    count = {"n": 0}

    def cb(carry):
        count["n"] += 1
        if count["n"] >= n_blocks:
            raise _Interrupt

    return cb


def _interrupted(fn, path, every, blocks, **kw):
    """Run ``fn`` with checkpoints every ``every`` iterations and stop it
    after ``blocks`` blocks."""
    with pytest.raises(_Interrupt):
        fn(checkpoint_path=path, checkpoint_every=every,
           on_block_end=_interrupt_after(blocks), **kw)


def test_save_load_roundtrip_pytree(tmp_path, rng):
    carry = {"a": torch.from_numpy(rng.random((4, 5))),
             "b": (rng.random(3), 7, True)}
    p = save_state(str(tmp_path / "ck"), carry)
    assert p.endswith(".npz")
    restored = load_state(p, carry)
    torch.testing.assert_close(restored["a"], carry["a"], rtol=0, atol=0)
    np.testing.assert_array_equal(restored["b"][0], carry["b"][0])
    assert restored["b"][1] == 7 and type(restored["b"][1]) is int
    assert restored["b"][2] is True
    with np.load(p, allow_pickle=True) as f:
        # tpunmf's layout: dict keys sorted, leaves in order, n_leaves
        assert sorted(f.files) == ["leaf_0", "leaf_1", "leaf_2", "leaf_3", "n_leaves"]
        assert int(f["n_leaves"]) == 4 and f["leaf_2"].dtype == np.int32
        assert f["leaf_3"].dtype == np.bool_


def test_loop_carry_leaves_in_tpunmf_s_order_and_types(tmp_path):
    w, h = torch.ones((6, 2), dtype=torch.bfloat16), torch.ones((2, 5))
    carry = init_carry(torch.tensor(1.25, dtype=torch.float64), 20, (w, h))
    p = save_state(str(tmp_path / "state.npz"), carry, meta="cfg")
    with np.load(p, allow_pickle=True) as f:
        assert [f[f"leaf_{i}"].dtype for i in range(6)] == [
            np.int32, np.float64, np.bool_, np.float64, np.float32, np.float32]
        assert f["meta"].item() == "cfg"
    got = load_state(p, carry, expected_meta="cfg")
    assert got.i == 0 and got.converged is False
    assert got.inner[0].dtype == torch.bfloat16 and got.obj.device.type == "cpu"
    torch.testing.assert_close(got.obj_buf, carry.obj_buf, equal_nan=True)


def test_mur_resume_matches_uninterrupted(tmp_path):
    kw = dict(distance_type="eu", min_iter=5, max_iter=60, tol1=1e-12,
              tol2=1e-12, nndsvd_init=(True, "zero"))
    full = mur(t(lowrank()), 5, **kw)
    ck = str(tmp_path / "mur_ck")
    _interrupted(lambda **k: mur(t(lowrank()), 5, **kw, **k), ck, 10, 2)
    assert checkpoint_exists(ck)
    resumed = mur(t(lowrank()), 5, **kw, checkpoint_path=ck, checkpoint_every=10,
                  resume=True)
    assert resumed.i == full.i
    np.testing.assert_allclose(resumed.obj_history, full.obj_history, rtol=1e-12)
    np.testing.assert_allclose(resumed.w, full.w, rtol=1e-12)


def test_admm_resume_restores_duals(tmp_path):
    kw = dict(distance_type="eu", reg_w=(0, "nn"), reg_h=(0.05, "l1n"),
              min_iter=5, max_iter=40, tol1=1e-12, tol2=1e-12,
              nndsvd_init=(True, "zero"))
    full = admm(t(lowrank()), 5, **kw)
    ck = str(tmp_path / "admm_ck")
    try:  # as in tpunmf's test: the run may converge before the third block
        admm(t(lowrank()), 5, **kw, checkpoint_path=ck, checkpoint_every=5,
             on_block_end=_interrupt_after(3))
    except _Interrupt:
        pass
    resumed = admm(t(lowrank()), 5, **kw, checkpoint_path=ck, checkpoint_every=5,
                   resume=True)
    np.testing.assert_allclose(resumed.obj_history, full.obj_history, rtol=1e-10)
    np.testing.assert_allclose(resumed.w, full.w, rtol=1e-10)


def test_mismatched_config_rejected(tmp_path):
    kw = dict(distance_type="eu", min_iter=2, tol1=1e-12, tol2=1e-12,
              nndsvd_init=(True, "zero"))
    ck = str(tmp_path / "ck")
    mur(t(lowrank()), 5, max_iter=10, checkpoint_path=ck, checkpoint_every=5, **kw)
    with pytest.raises(ValueError, match="mismatch"):
        mur(t(lowrank()), 5, max_iter=20, checkpoint_path=ck, checkpoint_every=5,
            resume=True, **kw)


def test_config_tag_rejects_different_regularization(tmp_path):
    kw = dict(distance_type="eu", min_iter=2, max_iter=20, tol1=1e-12,
              tol2=1e-12, nndsvd_init=(True, "zero"))
    ck = str(tmp_path / "ck")
    mur(t(lowrank()), 5, lambda_h=0.0, checkpoint_path=ck, checkpoint_every=5, **kw)
    with pytest.raises(ValueError, match="configuration mismatch"):
        mur(t(lowrank()), 5, lambda_h=0.5, checkpoint_path=ck, checkpoint_every=5,
            resume=True, **kw)


def test_a_transposed_view_resumes_as_one(tmp_path):
    """ADMM and ANLS carry W as a transposed view: it must come back so,
    or the products after a resume take another layout (and on the card
    other roundings) than the uninterrupted run's."""
    w = torch.arange(12.0).reshape(3, 4).T
    carry = (w, w.contiguous())
    got = load_state(save_state(str(tmp_path / "s"), carry), (w.contiguous(), w))
    assert got[0].stride() == w.stride() and got[1].stride() == (3, 1)
    torch.testing.assert_close(got[0], w, rtol=0, atol=0)
    torch.testing.assert_close(got[1], w, rtol=0, atol=0)


def test_leaf_shape_mismatch_rejected(tmp_path):
    carry = init_carry(torch.tensor(1.0), 10, (torch.ones(4, 2), torch.ones(2, 3)))
    p = save_state(str(tmp_path / "s"), carry)
    other = init_carry(torch.tensor(1.0), 10, (torch.ones(4, 3), torch.ones(3, 3)))
    with pytest.raises(ValueError, match="leaf 4 shape .* configuration mismatch"):
        load_state(p, other)


_X = lowrank()
_MASK = (np.random.default_rng(3).random(_X.shape) < 0.7).astype(np.float64)
_BASE = dict(min_iter=30, max_iter=30, tol1=1e-12, tol2=1e-12,
             nndsvd_init=(True, "zero"))
_NTF_INIT = [np.random.default_rng(4).random((n, 5)) + 0.1 for n in _X.shape]
_GRAPH = knn_graph(t(_X), 5).numpy()


def _no_nndsvd(kw):
    """ntf draws its own init: the keywords without nndsvd_init."""
    return {n: v for n, v in kw.items() if n != "nndsvd_init"}


def _factors(res):
    """The factors of a Results (w, h) or of an NtfResults (its list)."""
    return res.factors if hasattr(res, "factors") else (res.w, res.h)


SOLVERS = {
    "mur_eu": lambda x, **k: mur(x, 5, distance_type="eu", **_BASE, **k),
    "mur_kl": lambda x, **k: mur(x, 5, distance_type="kl", **_BASE, **k),
    "hals": lambda x, **k: hals(x, 5, **_BASE, **k),
    "admm_adaptive": lambda x, **k: admm(x, 5, distance_type="kl", rho_mode="adaptive",
                                         rho=10.0, reg_h=(0.05, "l1n"), **_BASE, **k),
    "anls": lambda x, **k: anls(x, 5, distance_type="eu", **_BASE, **k),
    "ao_admm_adaptive_local": lambda x, **k: ao_admm(
        x, 5, distance_type="eu", rho_mode="adaptive", reg_w=(0.1, "l1inf"),
        upper_bound=256.0, **{**_BASE, "max_iter": 12, "min_iter": 12}, **k),
    "mur_masked": lambda x, **k: mur_masked(x, t(_MASK), 5, distance_type="kl",
                                            **_BASE, **k),
    "mur_beta": lambda x, **k: mur_beta(x, 5, beta=0.5, **_BASE, **k),
    "ntf": lambda x, **k: ntf(x, 5, factors_init=_NTF_INIT, **_no_nndsvd(_BASE), **k),
    "gnmf": lambda x, **k: gnmf(x, 5, _GRAPH, **_BASE, **k),
}


@pytest.mark.parametrize("name", list(SOLVERS) + ["mur_eu_pair", "mur_kl_pair"])
def test_resume_equals_uninterrupted_run(tmp_path, name, monkeypatch):
    if name.endswith("_pair"):
        # the kernel-update route's carry, (w, h) for KL too: float64 X takes
        # the plain route unless the update kernels are said to take it
        monkeypatch.setattr(mur_module, "updates_take", lambda x, k: True)
        name = name[:-len("_pair")]
    fn = SOLVERS[name]
    extra = {"use_pallas": True} if name.startswith("mur_") and name != "mur_beta" else {}
    full = fn(t(_X), **extra)
    ck = str(tmp_path / name)
    every = 4
    _interrupted(lambda **k: fn(t(_X), **extra, **k), ck, every, 2)
    with np.load(ck + ".npz", allow_pickle=True) as f:
        assert int(f["leaf_0"]) == 2 * every
    resumed = fn(t(_X), checkpoint_path=ck, checkpoint_every=every, resume=True,
                 **extra)
    assert resumed.i == full.i
    np.testing.assert_allclose(resumed.obj_history, full.obj_history, rtol=1e-12)
    for a, b in zip(_factors(resumed), _factors(full), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300)


_CROSS = {
    "mur_eu": (lambda x, **k: mur(x, 5, distance_type="eu", **k),
               lambda x, **k: jmur(x, 5, distance_type="eu", **k)),
    "admm_eu": (lambda x, **k: admm(x, 5, distance_type="eu", reg_h=(0.05, "l1n"), **k),
                lambda x, **k: jadmm(x, 5, distance_type="eu", reg_h=(0.05, "l1n"), **k)),
    # the tag formats X's shape as tpunmf does, "(60, 48)": a torch.Size
    # there would refuse tpunmf's checkpoint
    "ntf": (lambda x, **k: ntf(x, 5, factors_init=_NTF_INIT, **_no_nndsvd(k)),
            lambda x, **k: jntf(x, 5, factors_init=_NTF_INIT, **_no_nndsvd(k))),
    "gnmf": (lambda x, **k: gnmf(x, 5, _GRAPH, lambda_g=0.5, **k),
             lambda x, **k: jgnmf(x, 5, _GRAPH, lambda_g=0.5, **k)),
}
_CROSS_KW = dict(min_iter=40, max_iter=40, tol1=1e-12, tol2=1e-12,
                 nndsvd_init=(True, "zero"))


@pytest.mark.parametrize("direction", ["tpunmf_to_port", "port_to_tpunmf"])
@pytest.mark.parametrize("name", list(_CROSS))
def test_checkpoints_cross_between_packages(tmp_path, name, direction):
    port, ref = _CROSS[name]
    want = ref(_X, **_CROSS_KW)
    ck = str(tmp_path / name)
    writer, reader = ((lambda **k: ref(_X, **k), lambda **k: port(t(_X), **k))
                      if direction == "tpunmf_to_port" else
                      (lambda **k: port(t(_X), **k), lambda **k: ref(_X, **k)))
    _interrupted(lambda **k: writer(**_CROSS_KW, **k), ck, 10, 2)
    assert jcheckpoint_exists(ck) and checkpoint_exists(ck)
    got = reader(checkpoint_path=ck, checkpoint_every=10, resume=True, **_CROSS_KW)
    assert got.i == want.i == 39
    assert_traces_match(got.obj_history, want.obj_history, rtol=TRACE_RTOL)
    for a, b in zip(_factors(got), _factors(want), strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8)


def test_kl_checkpoint_refused_on_the_other_route_kind(tmp_path, monkeypatch):
    """MUR KL carries (w, h) on the kernel-update routes and (w, h, r) on the
    plain and high-rank routes: the leaf count refuses a crossing."""
    kw = dict(distance_type="kl", min_iter=8, max_iter=8, nndsvd_init=(True, "zero"))
    ck = str(tmp_path / "kl")
    # float64 X takes the plain route; let the update kernels take it too,
    # so the CPU run takes the pair (as tests/test_torch_high_rank.py does)
    mur(t(_X), 5, checkpoint_path=ck, checkpoint_every=4, **kw)
    monkeypatch.setattr(mur_module, "updates_take", lambda x, k: True)
    assert mur_module.mur_route(t(_X), 5, "kl")[0] in ("pair", "single")
    with pytest.raises(ValueError, match="7 leaves but solver state has 6"):
        mur(t(_X), 5, checkpoint_path=ck, checkpoint_every=4, resume=True,
            use_pallas=True, **kw)
    ck2 = str(tmp_path / "kl_pair")
    mur(t(_X), 5, checkpoint_path=ck2, checkpoint_every=4, use_pallas=True, **kw)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="6 leaves but solver state has 7"):
        mur(t(_X), 5, checkpoint_path=ck2, checkpoint_every=4, resume=True, **kw)
