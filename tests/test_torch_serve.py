"""tpunmf_torch's serving top-k against tpunmf's, on the CPU.

The same numpy inputs go to ``tpunmf.serve.topk`` and to the port; values
and indices must be equal, ties and NaN included.  Factors are multiples
of 1/16 below 16, so every score is exact in float32 and the two packages'
products (summed in other orders) give the same bits.  n >= 40000 engages
the block-max route (n > 2 * 16384).  On the CPU the kernels' wrappers run
their plain versions; tests/test_torch_cuda.py holds the kernels to them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunmf
from _torch_parity import lowrank, t
from tpunmf.serve import topk as jtopk
from tpunmf_torch.io import convert
from tpunmf_torch.ops import topk_select as tselect
from tpunmf_torch.serve import topk as ttopk


def _dyadic(rng, shape, levels=256):
    return (rng.integers(0, levels, shape) / 16).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _factors(seed, b=6, r=16, n=40000, levels=256):
    rng = np.random.default_rng(seed)
    return _dyadic(rng, (b, r), levels), _dyadic(rng, (r, n), levels)


def _assert_same(got, want):
    gv, gi = (a.numpy() for a in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gv.shape == wv.shape and gi.dtype == np.int64
    np.testing.assert_array_equal(gv.astype(np.float64), wv.astype(np.float64))
    np.testing.assert_array_equal(gi, wi)


def _exclusion(n, b=6, frac=0.3, seed=5):
    return np.random.default_rng(seed).random((b, n)) < frac


# name -> (factors kwargs, k, topk_retrieval kwargs); exclusion masks are
# made from the factors' shape
CASES = {
    "random": (dict(seed=1), 10, {}),
    "ragged_n": (dict(seed=2, n=40001), 10, {}),
    "boundary_ties_fallback": (dict(seed=3, levels=2), 10, {}),
    "small_path_with_ties": (dict(seed=4, n=5000, levels=2), 10, {}),
    "wide_candidate_set": (dict(seed=5), 150, {}),
    "exclude": (dict(seed=6), 10, dict(exclude=True)),
    "exclude_ties_fallback": (dict(seed=7, levels=4), 10, dict(exclude=True)),
    "recall_target": (dict(seed=8), 10, dict(recall_target=0.9)),
    "recall_target_exclude": (dict(seed=9), 10,
                              dict(recall_target=0.9, exclude=True)),
    "bf16_first_stage": (dict(seed=10), 10, dict(first_stage_dtype="bf16")),
    "f16_first_stage": (dict(seed=11), 10, dict(first_stage_dtype="f16")),
    "bf16_stored": (dict(seed=12), 10, dict(first_stage_dtype="bf16", stored=True)),
    "f16_stored": (dict(seed=13), 10, dict(first_stage_dtype="f16", stored=True)),
    "bf16_exclude": (dict(seed=14), 10,
                     dict(first_stage_dtype="bf16", exclude=True, oversample=3)),
    "bf16_ties_fallback": (dict(seed=15, levels=4), 10,
                           dict(first_stage_dtype="bf16")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_retrieval_matches_tpunmf(name, monkeypatch):
    """Cases named *_fallback must reject the fast answer and sort."""
    fallbacks = []
    real = ttopk._blocked_topk
    monkeypatch.setattr(ttopk, "_blocked_topk",
                        lambda *a, **kw: fallbacks.append(1) or real(*a, **kw))
    fkw, k, kw = CASES[name]
    w, h = _factors(**fkw)
    kw = dict(kw)
    jkw, tkw = {}, {}
    if kw.pop("exclude", False):
        ex = _exclusion(h.shape[1])
        jkw["exclude"], tkw["exclude"] = jnp.asarray(ex), ex
    if kw.pop("stored", False):
        q = kw["first_stage_dtype"]
        jkw["h_quantized"] = jnp.asarray(h).astype(
            jnp.bfloat16 if q == "bf16" else jnp.float16)
        tkw["h_quantized"] = t(h).to(torch.bfloat16 if q == "bf16" else torch.float16)
    want = jtopk.topk_retrieval(None, jnp.asarray(w), jnp.asarray(h), k, **jkw, **kw)
    got = ttopk.topk_retrieval(None, t(w), t(h), k, **tkw, **kw)
    _assert_same(got, want)
    assert bool(fallbacks) == name.endswith("_fallback")
    if name == "exclude":
        assert not _exclusion(h.shape[1])[np.arange(6)[:, None], got[1].numpy()].any()


def test_dense_topk_matches_tpunmf_and_numpy():
    w, h = _factors(1)
    got = ttopk.topk_scores_dense(t(w), t(h), 10)
    _assert_same(got, jtopk.topk_scores_dense(jnp.asarray(w), jnp.asarray(h), 10))
    # lax.top_k's order: value descending, then lowest index first
    scores = w.astype(np.float64) @ h
    order = np.lexsort((np.arange(h.shape[1])[None, :].repeat(6, 0), -scores))[:, :10]
    np.testing.assert_array_equal(got[1].numpy(), order)


@pytest.mark.parametrize("case", ["constant_rows", "nan", "five_finite",
                                  "tie_in_unselected_block"])
def test_exact_topk_edge_cases_match_tpunmf(case):
    """The fallback paths of the block-max route, on score matrices that
    force them (tests/test_serve.py's cases), through _exact_topk and
    through the fused entry that rebuilds the scores from s3."""
    rng = np.random.default_rng(20)
    b, n, k, sel_extra = 3, 40000, 9, 8
    if case == "constant_rows":
        s = np.full((b, n), 0.25, np.float32)
    elif case == "nan":
        s = rng.random((b, n)).astype(np.float32)
        s[0, 12345] = s[2, 100] = s[2, 39999] = np.nan
    elif case == "five_finite":
        s = rng.random((b, n)).astype(np.float32)
        s[:, 5:] = -np.inf
        k = 12
    else:
        b, n, k, sel_extra = 2, 129 * 128 * 3, 5, 0
        s = np.minimum(rng.random((b, n)), 0.8).astype(np.float32)
        s[:, [3, 130, 260, 400, 523]] = 0.9
        s[:, 128 * 100 + 7] = 0.9
    want = jtopk._exact_topk(jnp.asarray(s), k, sel_extra=sel_extra)
    _assert_same(ttopk._exact_topk(t(s), k, sel_extra=sel_extra), want)
    bmax, s3 = tselect.blockmax_relayout(t(s))
    if case == "nan":
        assert torch.isnan(bmax).any()
    got = ttopk._exact_topk_core(bmax, s3, n, k, sel_extra=sel_extra)
    _assert_same(got, want)


def test_blocked_topk_and_wide_topk_match_tpunmf():
    rng = np.random.default_rng(21)
    s = rng.random((4, 1000)).astype(np.float32)
    s[:, [5, 400, 900]] = 0.999
    _assert_same(ttopk._blocked_topk(t(s), 17, block=128),
                 jtopk._blocked_topk(jnp.asarray(s), 17, block=128))
    wide = rng.standard_normal((4, 128 * 128 * 3)).astype(np.float32)
    wide[:, ::997] = wide[:, 149:150]  # the boundary value, spread widely
    _assert_same(ttopk._exact_topk(t(wide), 150), jtopk._exact_topk(jnp.asarray(wide), 150))


def test_quantized_stage_is_f32_accumulated():
    """The first stage's candidates are the top-c of the float32-accumulated
    bfloat16 product (a bfloat16 output would tie scores)."""
    rng = np.random.default_rng(22)
    w = rng.random((8, 32)).astype(np.float32)
    h = rng.random((32, 40000)).astype(np.float32)
    wq, hq = t(w).to(torch.bfloat16), t(h).to(torch.bfloat16)
    ref = wq.float() @ hq.float()
    _, cand = ttopk._scored_topk(wq, hq, 200)
    np.testing.assert_array_equal(cand.numpy(), ttopk._topk(ref, 200)[1].numpy())
    assert ttopk._score(wq, hq).dtype == torch.float32


@pytest.mark.parametrize("exclude", [False, True], ids=["plain", "exclude"])
def test_streaming_matches_tpunmf(exclude):
    """Panels with a ragged last one (230 = 3 * 64 + 38); with exclusion so
    heavy that fewer than k items remain, the empty slots carry -1."""
    rng = np.random.default_rng(23)
    b, r, n, k = 5, 8, 230, 7
    w, h = _dyadic(rng, (b, r)), _dyadic(rng, (r, n))
    kw = {}
    if exclude:
        ex = np.ones((b, n), dtype=bool)
        ex[:, [3, 70, 150, 229]] = False
        kw["exclude"] = ex
    want = jtopk.topk_streaming(w, h, n, k, panel_cols=64, **kw)
    got = ttopk.topk_streaming(t(w), h, n, k, panel_cols=64, **kw)
    _assert_same(got, want)
    if exclude:
        assert (got[1].numpy() == -1).sum() == b * (k - 4)
    called = ttopk.topk_streaming(t(w), lambda s, e: h[:, s:e], n, k,
                                  panel_cols=64, **kw)
    _assert_same(called, want)


def test_streaming_passes_every_panel_through_as_input(monkeypatch):
    """Each host panel goes to W's device through core/device.py::as_input
    (which makes float64 float32 on the card and keeps it on the CPU):
    three panels of 64, 64 and 22 columns, one call each, in order."""
    rng = np.random.default_rng(25)
    w, h = _dyadic(rng, (4, 8)), _dyadic(rng, (8, 150)).astype(np.float64)
    hosts, real = [], ttopk.as_input

    def counted(x, dtype=None, device=None):
        if not isinstance(x, torch.Tensor):
            hosts.append((x, device))
        return real(x, dtype=dtype, device=device)

    monkeypatch.setattr(ttopk, "as_input", counted)
    got = ttopk.topk_streaming(t(w), h, 150, 5, panel_cols=64)
    assert [(x.shape, d.type) for x, d in hosts] == [((8, 64), "cpu"), ((8, 64), "cpu"),
                                                      ((8, 22), "cpu")]
    for (x, _), start in zip(hosts, (0, 64, 128)):
        np.testing.assert_array_equal(x, h[:, start:start + x.shape[1]])
    want = ttopk.topk_scores_dense(t(w), t(h.astype(np.float32)), 5)
    assert got[0].dtype == torch.float64  # a CPU run keeps float64
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert torch.equal(got[1], want[1])


def test_quantized_streaming_matches_tpunmf():
    rng = np.random.default_rng(24)
    w, h = _dyadic(rng, (3, 8)), _dyadic(rng, (8, 150))
    want = jtopk.topk_streaming(w, h, 150, 5, panel_cols=50, first_stage_dtype="bf16",
                                oversample=5)
    got = ttopk.topk_streaming(t(w), h, 150, 5, panel_cols=50, first_stage_dtype="bf16",
                               oversample=5)
    _assert_same(got, want)


def test_recall_at_k_matches_tpunmf():
    pred = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    true = np.array([[1, 9], [4, 5], [-1, -1]])
    want = jtopk.recall_at_k(pred, true)
    assert ttopk.recall_at_k(torch.as_tensor(pred), torch.as_tensor(true)) == want
    assert ttopk.recall_at_k(pred, true) == want == 0.75


def test_serving_tpunmf_factors_through_convert():
    """Factors fitted by tpunmf, carried over by io/convert.py, give the
    same top-k in both packages (float64 here, as the fit)."""
    res = tpunmf.NMF(lowrank(m=60, n=48), 5).factorize(
        method="mur", distance_type="eu", min_iter=5, max_iter=20)
    port = convert.results_to_torch(res)
    want = jtopk.topk_scores_dense(jnp.asarray(res.w[:8]), jnp.asarray(res.h), 6)
    got = ttopk.topk_scores_dense(port.w[:8], port.h, 6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-12)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.float64


@pytest.mark.parametrize("value,fused", [("1", True), ("TRUE", True), ("yes", True),
                                         ("0", False), ("false", False), ("No", False)])
def test_fused_scoring_gate_parses_a_boolean(monkeypatch, value, fused):
    w, h = _factors(1)
    calls = []
    real = ttopk.score_blockmax_relayout
    monkeypatch.setattr(ttopk, "score_blockmax_relayout",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setenv("TPUNMF_FUSED_SCORING", value)
    got = ttopk.topk_scores_dense(t(w), t(h), 10)
    assert bool(calls) == fused
    _assert_same(got, jtopk.topk_scores_dense(jnp.asarray(w), jnp.asarray(h), 10))


def test_fused_scoring_gate_rejects_other_values(monkeypatch):
    w, h = _factors(1)
    monkeypatch.setenv("TPUNMF_FUSED_SCORING", "maybe")
    with pytest.raises(ValueError, match="TPUNMF_FUSED_SCORING"):
        ttopk.topk_scores_dense(t(w), t(h), 10)


def test_fused_route_needs_f32_scores_and_a_rank_in_range():
    w, h = _factors(1)
    assert tselect.score_blockmax_fits(64, 1024, 4)
    assert not tselect.score_blockmax_fits(64, 1025, 4)
    assert not tselect.score_blockmax_fits(64, 128, 4, sel_block=192)
    # float64 factors score in float64, outside the kernel
    got = ttopk.topk_scores_dense(t(w).double(), t(h).double(), 10)
    assert got[0].dtype == torch.float64


class _EightCols:
    """A mesh's axis sizes alone: 'cols' of 8 ranks."""

    mesh_dim_names = ("cols",)

    def size(self, dim=None):
        return 8


def test_argument_checks_match_tpunmf():
    w, h = _factors(1, n=300)
    hq = t(h).to(torch.bfloat16)
    with pytest.raises(ValueError, match="first_stage_dtype"):
        ttopk.topk_retrieval(None, t(w), t(h), 5, first_stage_dtype="int4")
    with pytest.raises(ValueError, match="requires first_stage_dtype"):
        ttopk.topk_retrieval(None, t(w), t(h), 5, h_quantized=hq)
    with pytest.raises(ValueError, match="does not match"):
        ttopk.topk_retrieval(None, t(w), t(h), 5, first_stage_dtype="f16", h_quantized=hq)
    # sharded serving is ported: with 8 ranks on 'cols', n = 300 items fail
    # tpunmf's own divisibility check (topk_streaming pads its panels, so
    # there it is the item count's check); both checks come before any
    # collective, so the port's side needs only the mesh's axis sizes
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("cols",))
    with pytest.raises(ValueError, match="not divisible by 'cols'=8") as got:
        ttopk.topk_retrieval(_EightCols(), t(w), t(h), 5)
    with pytest.raises(ValueError) as want:
        jtopk.topk_retrieval(jmesh, w, h, 5)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="exceeds") as got:
        ttopk.topk_streaming(t(w), h, 300, 301, mesh=_EightCols())
    with pytest.raises(ValueError) as want:
        jtopk.topk_streaming(w, h, 300, 301, mesh=jmesh)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="exceeds"):
        ttopk.topk_streaming(t(w), h, 300, 301)
