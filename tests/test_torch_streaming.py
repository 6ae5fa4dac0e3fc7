"""tpunmf_torch's out-of-core MUR against tpunmf's, on the CPU at float64.

The same scipy matrices and inits go to ``tpunmf.solvers.streaming.
mur_streaming`` (x64 on) and to the port on CPU tensors: traces within
1e-10 relative, factors within 1e-8, the same ``i``, on ragged 32-wide
tiles of 90x70 (tests/test_streaming.py's recipe), an all-zero column band
(empty tiles skipped; KL's exact sum for them), COO input with duplicate
coordinates and bf16 transfer, with the same tiles densified.  Then the
device rule, the KL tiles' route rule, the update rules on batches, the
pipeline's CPU loop, ``topk_streaming`` from a callable source, and the
port's imports without JAX.
"""
import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_parity import assert_traces_match, t
from tpunmf.serve import topk as jtopk
from tpunmf.solvers import streaming as jstreaming
from tpunmf_torch.data.pipeline import PanelPipeline
from tpunmf_torch.init import random_init
from tpunmf_torch.serve import topk as ttopk
from tpunmf_torch.solvers import mur_streaming

streaming = importlib.import_module("tpunmf_torch.solvers.streaming")
experiments = importlib.import_module("tpunmf_torch.experiments")

FACTOR_RTOL = 1e-8
TILES = dict(row_block=32, col_panel=32)


def _problem(seed=42, m=90, n=70, k=6, band=False, rounding=False):
    """(csr, w0, h0): values exact in float32 (or, with ``rounding``, not
    exact in bfloat16), about half of them zero; with ``band`` columns
    32-63 are all zero (empty tiles)."""
    rng = np.random.default_rng(seed)
    dense = rng.random((m, n)) if rounding else np.round(rng.random((m, n)) * 256) / 256
    dense[dense < 0.5] = 0.0
    if band:
        dense[:, 32:64] = 0.0
    w0, h0 = rng.random((m, k)) + 0.1, rng.random((k, n)) + 0.1
    return sp.csr_matrix(dense), w0, h0


def _streams(monkeypatch):
    """Capture the PanelStreams both solvers make."""
    made = {"jax": [], "torch": []}
    for name, module in (("jax", jstreaming), ("torch", streaming)):
        real = module.PanelStream

        def capture(*a, _real=real, _name=name, **kw):
            stream = _real(*a, **kw)
            made[_name].append(stream)
            return stream

        monkeypatch.setattr(module, "PanelStream", capture)
    return made


def _run_both(csr, w0, h0, *, jkw=None, tkw=None, **kw):
    kw = {**TILES, "min_iter": 3, "max_iter": 20, "tol1": 1e-12, "tol2": 1e-12, **kw}
    want = jstreaming.mur_streaming(csr, w0.shape[1], w_init=w0, h_init=h0,
                                    dtype=jnp.float64, **kw, **(jkw or {}))
    got = mur_streaming(csr, w0.shape[1], w_init=t(w0), h_init=t(h0), dtype=torch.float64,
                        **kw, **(tkw or {}))
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)
    for a, b in ((got.w, want.w), (got.h, want.h)):
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=FACTOR_RTOL, atol=FACTOR_RTOL * np.abs(b).max())
    assert tuple(got.experiment) == tuple(want.experiment)
    return got, want


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_ragged_tiles_match_tpunmf(dist):
    _run_both(*_problem(), distance_type=dist)


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_an_empty_band_matches_tpunmf_with_the_same_tiles_densified(dist, monkeypatch):
    made = _streams(monkeypatch)
    csr, w0, h0 = _problem(band=True)
    got, _ = _run_both(csr, w0, h0, distance_type=dist, max_iter=8)
    (tstream,), (jstream,) = made["torch"], made["jax"]
    assert tstream.densify_count == jstream.densify_count
    # 9 tiles, 3 of them empty: EU passes 1 + 2 an iteration, KL 3 an
    # iteration and the initial objective
    passes = 1 + 2 * (got.i + 1) if dist == "eu" else 1 + 3 * (got.i + 1)
    assert tstream.densify_count == 6 * passes


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_regularized_runs_without_the_skip_match_tpunmf(dist):
    _run_both(*_problem(seed=3, band=True), distance_type=dist, lambda_w=0.1,
              lambda_h=0.05, skip_empty_panels=False, max_iter=6)


def test_an_early_stop_matches_tpunmf():
    got, _ = _run_both(*_problem(seed=5), distance_type="eu", min_iter=2, max_iter=50,
                       tol1=1e-5, tol2=1.0)
    assert 2 < got.i < 49


def test_coo_duplicates_match_tpunmf():
    rng = np.random.default_rng(7)
    rows, cols = rng.integers(0, 40, 300), rng.integers(0, 50, 300)
    vals = np.round(rng.random(300) * 64) / 64 + 0.25
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(40, 50))
    assert coo.nnz > coo.tocsr().nnz  # duplicates present
    w0, h0 = rng.random((40, 4)) + 0.1, rng.random((4, 50)) + 0.1
    for dist in ("eu", "kl"):
        _run_both(coo, w0, h0, distance_type=dist, row_block=16, col_panel=16, max_iter=8)


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_bf16_transfer_matches_tpunmf(dist):
    """The same bf16-rounded data and ||X||^2 from the rounded values: the
    data here do not survive bf16, so float32 transfer gives another run."""
    csr, w0, h0 = _problem(seed=11, rounding=True)
    got, _ = _run_both(csr, w0, h0, distance_type=dist, max_iter=8,
                       jkw=dict(transfer_dtype=jnp.bfloat16),
                       tkw=dict(transfer_dtype=torch.bfloat16))
    f32 = mur_streaming(csr, 6, w_init=t(w0), h_init=t(h0), dtype=torch.float64,
                        distance_type=dist, max_iter=8, **TILES)
    assert abs(got.obj_history[0] - f32.obj_history[0]) > 1e-6 * abs(f32.obj_history[0])


def test_errors_are_tpunmf_s():
    csr, w0, h0 = _problem()
    with pytest.raises(KeyError):
        mur_streaming(csr, 6, distance_type="is", device="cpu")
    with pytest.raises(ValueError, match="transfer_dtype"):
        mur_streaming(csr, 6, transfer_dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="both"):
        mur_streaming(csr, 6, w_init=t(w0), device="cpu")


def test_the_state_lives_on_the_card_unless_asked(monkeypatch):
    csr, w0, h0 = _problem()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mur_streaming(csr, 6, max_iter=2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mur_streaming(csr, 6, w_init=w0, h_init=h0, max_iter=2)  # numpy inits
    res = mur_streaming(csr, 6, device="cpu", min_iter=1, max_iter=2, **TILES)
    w, h = random_init(0, 90, 70, 6, kind="abs_normal")  # the default seed
    want = mur_streaming(csr, 6, w_init=w, h_init=h, min_iter=1, max_iter=2, **TILES)
    assert res.w.dtype == np.float32
    np.testing.assert_array_equal(res.w, want.w)
    assert res.obj_history == want.obj_history
    seeded = mur_streaming(csr, 6, device="cpu", key=3, min_iter=1, max_iter=2, **TILES)
    assert not np.array_equal(seeded.w, res.w)


def _counted(monkeypatch, name):
    calls = []
    real = getattr(streaming, name)
    monkeypatch.setattr(streaming, name, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("transfer", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_kl_tiles_take_the_kernels_on_the_kernel_route(transfer, monkeypatch):
    """float32 factors with use_pallas: each nonempty tile's ratio is
    kl_ratio (twice an iteration) and its objective kl_obj (once an
    objective), here their plain versions; the route's bits are the plain
    route's, which calls neither."""
    csr, w0, h0 = _problem(band=True)
    kw = dict(w_init=t(w0).float(), h_init=t(h0).float(), distance_type="kl", min_iter=3,
              max_iter=4, tol1=0.0, tol2=0.0, transfer_dtype=transfer, **TILES)
    plain_ratio, plain_obj = _counted(monkeypatch, "kl_ratio_ref"), \
        _counted(monkeypatch, "kl_obj_ref")
    plain = mur_streaming(csr, 6, use_pallas=False, **kw)
    assert plain_ratio and plain_obj
    monkeypatch.setattr(streaming, "objective_takes", lambda x, k: True)
    ratio, obj = _counted(monkeypatch, "kl_ratio"), _counted(monkeypatch, "kl_obj")
    del plain_ratio[:], plain_obj[:]
    got = mur_streaming(csr, 6, use_pallas=True, **kw)
    assert (len(ratio), len(obj)) == (2 * 6 * (got.i + 1), 6 * (got.i + 2))
    assert not plain_ratio and not plain_obj
    np.testing.assert_array_equal(got.w, plain.w)
    assert got.obj_history == plain.obj_history


@pytest.mark.parametrize("case", ["use_pallas=False", "float64", "eu"])
def test_the_plain_route_calls_no_kernel_wrapper(case, monkeypatch):
    for name in ("kl_ratio", "kl_obj"):
        monkeypatch.setattr(streaming, name, lambda *a, **kw: pytest.fail("a kernel wrapper"))
    monkeypatch.setattr(streaming, "objective_takes", lambda x, k: True)
    csr, w0, h0 = _problem()
    dtype = torch.float64 if case == "float64" else torch.float32
    mur_streaming(csr, 6, w_init=t(w0), h_init=t(h0), dtype=dtype, max_iter=3,
                  distance_type="eu" if case == "eu" else "kl",
                  use_pallas=case != "use_pallas=False", **TILES)


def test_the_update_rules_are_one_copy_and_take_batches():
    rng = np.random.default_rng(9)
    ws, hs = t(rng.random((3, 12, 4))), t(rng.random((3, 4, 10)))
    numer_w, numer_h = t(rng.random((3, 12, 4))), t(rng.random((3, 4, 10)))
    lam = t(np.array([0.0, 0.1, 0.5]).reshape(3, 1, 1))
    for rule, args in (
            (streaming._mur_w_update_eu, (ws, numer_w, hs @ hs.transpose(1, 2), lam)),
            (streaming._mur_h_update_eu, (hs, numer_h, ws.transpose(1, 2) @ ws, lam)),
            (streaming._mur_w_update_kl, (ws, numer_w, hs, lam)),
            (streaming._mur_h_update_kl, (hs, numer_h, ws, lam))):
        assert getattr(experiments, rule.__name__) is rule
        batched = rule(*args)
        for b in range(3):
            np.testing.assert_allclose(batched[b].numpy(),
                                       rule(*(a[b] for a in args[:3]), float(lam[b])).numpy(),
                                       rtol=1e-14)
            want = getattr(jstreaming, rule.__name__)(*(a[b].numpy() for a in args[:3]),
                                                      float(lam[b]))
            np.testing.assert_allclose(batched[b].numpy(), np.asarray(want), rtol=1e-14)


def test_the_pipeline_on_the_cpu_is_the_plain_loop():
    pipe = PanelPipeline(12, torch.float32, "cpu")
    filled = []

    def fill(item, host):
        filled.append(item)
        host.fill_(float(item))

    seen = []
    for item, panel in pipe.run([3, 1, 2], fill, lambda item: (item, 2)):
        assert filled == [3, 1, 2][:len(seen) + 1]  # filled just before its turn
        assert panel.shape == (item, 2) and bool((panel == item).all())
        seen.append(item)
    assert seen == [3, 1, 2]
    with pytest.raises(ValueError, match="2 slots"):
        PanelPipeline(12, torch.float32, "cpu", slots=1)


def test_topk_streaming_from_a_callable_with_exclusions_is_tpunmf_s():
    """A ragged last panel (150 = 64 + 64 + 22 items) and exclusions that
    leave fewer than k items in a row: tpunmf's values and indices, the
    -1 scrub included; multiples of 1/16 keep every score exact."""
    rng = np.random.default_rng(31)
    w = (rng.integers(0, 16, (5, 8)) / 16).astype(np.float32)
    h = (rng.integers(0, 16, (8, 150)) / 16).astype(np.float32)
    exclude = rng.random((5, 150)) < 0.2
    exclude[2, 3:] = True  # three items left in row 2
    panels = []

    def source(start, stop):
        panels.append((start, stop))
        return h[:, start:stop]

    want = jtopk.topk_streaming(w, h, 150, 7, panel_cols=64, exclude=exclude)
    got = ttopk.topk_streaming(t(w), source, 150, 7, panel_cols=64, exclude=exclude)
    assert panels == [(0, 64), (64, 128), (128, 150)]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1][2, 3:] == -1).all() and torch.isneginf(got[0][2, 3:]).all()


def test_the_port_imports_without_jax():
    """The out-of-core path and its host code import neither JAX, nor
    tpunmf, nor ml_dtypes (the card's machine has none of them)."""
    code = textwrap.dedent("""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "tpunmf", "ml_dtypes"):
                    raise ImportError("blocked: " + name)
        for name in list(sys.modules):
            if name.split(".")[0] in ("jax", "jaxlib", "tpunmf", "ml_dtypes"):
                del sys.modules[name]
        sys.meta_path.insert(0, Block())
        import tpunmf_torch.solvers.streaming, tpunmf_torch.data, tpunmf_torch.native
        import tpunmf_torch.serve.topk, tpunmf_torch.experiments
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
