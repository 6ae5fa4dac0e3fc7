"""tpunmf_torch.parallel across 4 gloo processes against tpunmf.parallel.

One 4-process world a module (``world`` fixture): the parent makes the
inputs from a numpy seed, starts ``_torch_dist_worker.py`` on 4 ranks
(``initialize_multihost`` over a free localhost port, CPU meshes (2, 2)
and (4,)), and each rank writes its blocks at float64.  Here the blocks are
reassembled by their layouts, every replica must be the same bits, and the
result is held against ``tpunmf`` on a JAX mesh of the same shape over 4
of the 8 CPU devices.  A world that hangs is killed at its timeout and
fails the test.
"""
from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import scipy.sparse as sp

from tpunmf import NMF as JNMF
from tpunmf import parallel as jpar
from tpunmf.serve import topk as jtopk
from tpunmf.solvers import mur_streaming_sharded as j_streaming_sharded

from _torch_parity import gloo_world

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_worker.py")
_WORLD = 4
_TIMEOUT = 180
# (shape, axis names) of the workers' meshes, tests/_torch_dist_worker.py
_MESHES = {"m22": ((2, 2), ("rows", "cols")), "m4": ((4,), ("cols",)),
           "r4": ((4,), ("rank",)), "r22": ((2, 2), ("rows", "rank"))}
_STOP = dict(min_iter=5, max_iter=300, tol1=0.0, tol2=1e-3)


def _inputs():
    rng = np.random.default_rng(2024)
    x = rng.random((16, 24)) + 0.05
    xkl = rng.random((16, 24))
    xkl[xkl < 0.25] = 0.0  # exact zeros: the KL masking
    w0, h0 = rng.random((16, 4)) + 0.1, rng.random((4, 24)) + 0.1
    dense = rng.random((40, 96))
    dense[dense < 0.6] = 0.0
    csr = sp.csr_matrix(dense)

    def dyadic(shape):  # exact in bf16, so every stage's scores are exact
        return (rng.integers(0, 256, shape) / 16).astype(np.float32)

    return dict(x=x, xkl=xkl, w0=w0, h0=h0, tol2=np.array(_STOP["tol2"]),
                csr_data=csr.data, csr_indices=csr.indices, csr_indptr=csr.indptr,
                csr_shape=np.array(csr.shape), sw0=rng.random((40, 3)) + 0.1,
                sh0=rng.random((3, 96)) + 0.1, wb=dyadic((5, 8)), hs=dyadic((8, 96)),
                excl=rng.random((5, 96)) < 0.2, hstream=dyadic((8, 150)),
                excl_s=rng.random((5, 150)) < 0.2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs and every rank's outputs (``_torch_parity.gloo_world``)."""
    return gloo_world(tmp_path_factory, "torch_world", _WORKER, _inputs(), _WORLD, _TIMEOUT)


def _coords(ranks, mesh):
    names = _MESHES[mesh][1]
    return [{a: int(r[f"coords/{mesh}/{a}"]) for a in names} for r in ranks]


def assemble(world, key, mesh, layout, replicas_rtol=0.0):
    """The global array from every rank's block of ``key`` under
    ``layout``; replicas must be the same bits (or within
    ``replicas_rtol``, where each rank sums in its own order)."""
    _, ranks = world
    shape, names = _MESHES[mesh]
    sizes = dict(zip(names, shape))
    blocks = [r[key] for r in ranks]
    gshape = [b * (sizes[a] if a else 1) for b, a in zip(blocks[0].shape, layout)]
    out = np.full(gshape, np.nan)
    seen = {}
    for block, coords in zip(blocks, _coords(ranks, mesh)):
        index = tuple(slice(coords[a] * b, (coords[a] + 1) * b) if a else slice(None)
                      for b, a in zip(block.shape, layout))
        where = tuple((s.start, s.stop) for s in index)
        if where in seen:
            np.testing.assert_allclose(block, seen[where], rtol=replicas_rtol, atol=0,
                                       err_msg=f"{key}: replicas differ")
        seen[where] = block
        out[index] = block
    assert not np.isnan(out).any(), key
    return out


def same_on_every_rank(world, key):
    _, ranks = world
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    return ranks[0][key]


@pytest.fixture(scope="module")
def jmeshes():
    devices = jax.devices()[:_WORLD]
    return {name: jpar.build_mesh(shape, names, devices=devices)
            for name, (shape, names) in _MESHES.items()}


def _np(a):
    return np.asarray(a)


# ---------------------------------------------------------------------------
# the collectives and shard_problem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_shard_problem_blocks(world, jmeshes, mesh):
    inp, _ = world
    sh = {"m22": (("rows", "cols"), ("rows", None), (None, "cols")),
          "m4": ((None, "cols"), (None, None), (None, "cols"))}[mesh]
    jv, jw, jh = jpar.shard_problem(jmeshes[mesh], inp["x"], inp["w0"], inp["h0"])
    for name, layout, want in zip("xwh", sh, (jv, jw, jh)):
        got = assemble(world, f"shard/{mesh}/{name}", mesh, layout)
        np.testing.assert_array_equal(got, _np(want))


@pytest.mark.parametrize("mesh", ["m22", "m4"])
@pytest.mark.parametrize("fn", ["gram_h", "gram_w", "xht_psum", "wtx_psum", "ring_xht"])
def test_collectives_on_the_canonical_layout(world, jmeshes, mesh, fn):
    inp, _ = world
    jm = jmeshes[mesh]
    x, w, h = jpar.shard_problem(jm, inp["x"], inp["w0"], inp["h0"])
    want = {"gram_h": lambda: jpar.gram_h(jm, h), "gram_w": lambda: jpar.gram_w(jm, w),
            "xht_psum": lambda: jpar.xht_psum(jm, x, h),
            "wtx_psum": lambda: jpar.wtx_psum(jm, w, x),
            "ring_xht": lambda: jpar.ring_xht(jm, x, h)}[fn]()
    rows = "rows" if mesh == "m22" else None
    layout = {"gram_h": (None, None), "gram_w": (None, None), "xht_psum": (rows, None),
              "wtx_psum": (None, "cols"), "ring_xht": (rows, None)}[fn]
    # the ring's ranks add the same terms, each in its own order
    got = assemble(world, f"coll/{mesh}/{fn}", mesh, layout,
                   replicas_rtol=1e-14 if fn == "ring_xht" else 0.0)
    np.testing.assert_allclose(got, _np(want), rtol=1e-10)


@pytest.mark.parametrize("mesh", ["m22", "m4"])
@pytest.mark.parametrize("fn", ["rows_to_cols", "cols_to_rows", "ring_xht_rotate_h"])
def test_layout_flips_and_the_rotate_h_ring(world, jmeshes, mesh, fn):
    inp, _ = world
    jm = jmeshes[mesh]
    x = jax.device_put(inp["x"], jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec("cols", None)))
    if fn == "ring_xht_rotate_h":
        want, layout = jpar.ring_xht_rotate_h(jm, x, inp["h0"]), ("cols", None)
    elif fn == "rows_to_cols":
        want, layout = jpar.reshard_rows_to_cols(jm, x), (None, "cols")
    else:
        want = jpar.reshard_cols_to_rows(jm, jpar.reshard_rows_to_cols(jm, x))
        layout = ("cols", None)
    got = assemble(world, f"coll/{mesh}/{fn}", mesh, layout)
    np.testing.assert_allclose(got, _np(want), rtol=1e-10)
    if fn == "cols_to_rows":
        np.testing.assert_array_equal(got, inp["x"])


@pytest.mark.parametrize("mesh", ["r4", "r22"])
@pytest.mark.parametrize("fn", ["wh_psum_rank", "gram_h_rank"])
def test_rank_collectives(world, jmeshes, mesh, fn):
    inp, _ = world
    jm = jmeshes[mesh]
    ns = jax.sharding.NamedSharding
    spec = jax.sharding.PartitionSpec
    w = jax.device_put(inp["w0"], ns(jm, spec(None, "rank")))
    h = jax.device_put(inp["h0"], ns(jm, spec("rank", None)))
    if fn == "wh_psum_rank":
        want, layout = jpar.wh_psum_rank(jm, w, h), (None, None)
    else:
        want, layout = jpar.gram_h_rank(jm, h), ("rank", None)
    got = assemble(world, f"coll/{mesh}/{fn}", mesh, layout)
    np.testing.assert_allclose(got, _np(want), rtol=1e-10)


# ---------------------------------------------------------------------------
# the schedules, 10 iterations on the local blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_mur_ulysses(world, jmeshes, mesh, dist):
    inp, _ = world
    x = inp["x"] if dist == "eu" else inp["xkl"]
    w, h, obj = jpar.mur_ulysses(jmeshes[mesh], x, inp["w0"], inp["h0"], n_iter=10,
                                 distance_type=dist)
    axis = _MESHES[mesh][1][0]
    key = f"ulysses/{dist}/{mesh}"
    np.testing.assert_allclose(assemble(world, key + "/w", mesh, (axis, None)), _np(w),
                               rtol=1e-8)
    np.testing.assert_allclose(assemble(world, key + "/h", mesh, (None, None)), _np(h),
                               rtol=1e-8)
    np.testing.assert_allclose(same_on_every_rank(world, key + "/obj"), float(obj), rtol=1e-9)


@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("mesh", ["r4", "r22"])
def test_mur_rank_sharded(world, jmeshes, mesh, dist):
    inp, _ = world
    x = inp["x"] if dist == "eu" else inp["xkl"]
    w, h, obj = jpar.mur_rank_sharded(jmeshes[mesh], x, inp["w0"], inp["h0"], n_iter=10,
                                      distance_type=dist, lambda_w=0.1, lambda_h=0.05)
    key = f"rank/{dist}/{mesh}"
    np.testing.assert_allclose(assemble(world, key + "/w", mesh, (None, "rank")), _np(w),
                               rtol=1e-8)
    np.testing.assert_allclose(assemble(world, key + "/h", mesh, ("rank", None)), _np(h),
                               rtol=1e-8)
    np.testing.assert_allclose(same_on_every_rank(world, key + "/obj"), float(obj), rtol=1e-9)


# ---------------------------------------------------------------------------
# the drivers: global data in, the same Results on every rank
# ---------------------------------------------------------------------------

def _same_results(world, key, want, rtol_trace, rtol_factors):
    i = int(same_on_every_rank(world, key + "/i"))
    assert i == want.i < _STOP["max_iter"] - 1  # an early stop, at the same iteration
    np.testing.assert_allclose(same_on_every_rank(world, key + "/obj"),
                               np.asarray(want.obj_history), rtol=rtol_trace)
    np.testing.assert_allclose(same_on_every_rank(world, key + "/w"), np.asarray(want.w),
                               rtol=rtol_factors)
    np.testing.assert_allclose(same_on_every_rank(world, key + "/h"), np.asarray(want.h),
                               rtol=rtol_factors)


@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("mesh", ["m22", "m4"])
@pytest.mark.parametrize("schedule", ["ulysses", "rank"])
def test_mur_sharded_stops_where_tpunmf_does(world, jmeshes, schedule, mesh, dist):
    inp, _ = world
    x = inp["x"] if dist == "eu" else inp["xkl"]
    want = jpar.mur_sharded(x, 4, jmeshes[mesh], schedule=schedule, distance_type=dist,
                            w_init=inp["w0"], h_init=inp["h0"], lambda_w=0.1, **_STOP)
    _same_results(world, f"sharded/{schedule}/{mesh}/{dist}", want, 1e-8, 1e-6)


def test_mur_sharded_nndsvd_init_is_made_once_and_broadcast(world, jmeshes):
    inp, _ = world
    want = jpar.mur_sharded(inp["x"], 4, jmeshes["m22"], schedule="ulysses",
                            distance_type="eu", nndsvd_init=(True, "zero"), min_iter=3,
                            max_iter=3)
    np.testing.assert_allclose(same_on_every_rank(world, "sharded/nndsvd/obj"),
                               np.asarray(want.obj_history), rtol=1e-9)
    np.testing.assert_allclose(same_on_every_rank(world, "sharded/nndsvd/w"),
                               np.asarray(want.w), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_facade_mesh_is_tpunmf_s_gspmd_run(world, jmeshes, mesh, dist):
    inp, _ = world
    x = inp["x"] if dist == "eu" else inp["xkl"]
    want = JNMF(x, 4, mesh=jmeshes[mesh]).factorize(
        method="mur", distance_type=dist, w_init=inp["w0"], h_init=inp["h0"], lambda_h=0.1,
        **_STOP)
    _same_results(world, f"facade/{mesh}/{dist}", want, 1e-9, 1e-6)


def test_facade_schedule_takes_factorize_s_mesh(world, jmeshes):
    inp, _ = world
    want = JNMF(inp["x"], 4).factorize(method="mur", schedule="rank", mesh=jmeshes["r4"],
                                       distance_type="eu", w_init=inp["w0"],
                                       h_init=inp["h0"], **_STOP)
    np.testing.assert_allclose(same_on_every_rank(world, "facade/schedule/obj"),
                               np.asarray(want.obj_history), rtol=1e-8)


@pytest.mark.parametrize("run", ["eu/exact", "kl/exact", "kl/lagged"])
@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_mur_streaming_sharded(world, jmeshes, mesh, run):
    inp, _ = world
    dist, objective = run.split("/")
    csr = sp.csr_matrix((inp["csr_data"], inp["csr_indices"], inp["csr_indptr"]),
                        shape=tuple(inp["csr_shape"]))
    want = j_streaming_sharded(csr, 3, jmeshes[mesh], distance_type=dist, objective=objective,
                               w_init=inp["sw0"], h_init=inp["sh0"], dtype=np.float64,
                               row_block=16, min_iter=2, max_iter=6, tol1=0.0, tol2=0.0,
                               lambda_w=0.05)
    key = f"streaming/{mesh}/{run}"
    np.testing.assert_allclose(same_on_every_rank(world, key + "/obj"),
                               np.asarray(want.obj_history), rtol=1e-8)
    for f in ("w", "h"):
        np.testing.assert_allclose(same_on_every_rank(world, f"{key}/{f}"),
                                   np.asarray(getattr(want, f)), rtol=1e-8)


# ---------------------------------------------------------------------------
# sharded serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "exclude", "quantized", "stored"])
@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_sharded_topk_retrieval(world, jmeshes, mesh, mode):
    inp, _ = world
    kw = {"exact": {}, "exclude": {"exclude": inp["excl"]},
          "quantized": {"first_stage_dtype": "bf16"},
          "stored": {"first_stage_dtype": "bf16",
                     "h_quantized": jax.numpy.asarray(inp["hs"], jax.numpy.bfloat16)}}[mode]
    vals, idx = jtopk.topk_retrieval(jmeshes[mesh], inp["wb"], inp["hs"], 7, **kw)
    key = f"topk/{mesh}/{mode}"
    np.testing.assert_array_equal(same_on_every_rank(world, key + "/idx"), _np(idx))
    np.testing.assert_allclose(same_on_every_rank(world, key + "/vals"), _np(vals),
                               rtol=1e-12)


@pytest.mark.parametrize("mode", ["plain", "exclude"])
@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_sharded_topk_streaming_pads_the_ragged_tail(world, jmeshes, mesh, mode):
    inp, _ = world
    kw = {} if mode == "plain" else {"exclude": inp["excl_s"]}
    h = inp["hstream"]
    vals, idx = jtopk.topk_streaming(inp["wb"], h, h.shape[1], 7, panel_cols=64,
                                     mesh=jmeshes[mesh], **kw)
    key = f"topk_streaming/{mesh}/{mode}"
    np.testing.assert_array_equal(same_on_every_rank(world, key + "/idx"), _np(idx))
    np.testing.assert_allclose(same_on_every_rank(world, key + "/vals"), _np(vals),
                               rtol=1e-12)


@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_sharded_topk_refuses_an_indivisible_item_axis(world, mesh):
    with pytest.raises(ValueError) as want:
        jtopk.topk_retrieval(jpar.build_mesh(_MESHES[mesh][0], _MESHES[mesh][1],
                                             devices=jax.devices()[:_WORLD]),
                             world[0]["wb"], world[0]["hs"][:, :-1], 7)
    assert str(same_on_every_rank(world, f"topk/{mesh}/indivisible")) == str(want.value)


# ---------------------------------------------------------------------------
# multihost: ingestion, consistency, and what a schedule sends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_host_local_columns_and_their_assembly(world, mesh):
    """Two hosts of two ranks (LOCAL_WORLD_SIZE=2): on (4,) each host owns
    half of the items, on (2, 2) each host a whole row of the mesh, so all
    of them; each rank keeps its own column block of its host's panel."""
    inp, ranks = world
    n = inp["x"].shape[1]
    for r, rank in enumerate(ranks):
        want = (0, n) if mesh == "m22" else ((0, n // 2) if r < 2 else (n // 2, n))
        assert tuple(rank[f"host/{mesh}/range"]) == want
    got = assemble(world, f"host/{mesh}/block", mesh, (None, "cols"))
    np.testing.assert_array_equal(got, inp["x"])


def test_collective_consistency_raises_when_one_rank_differs(world):
    _, ranks = world
    for rank in ranks:
        msg = str(rank["consistency/raised"])
        assert "host 0 and host 3 disagree" in msg, msg


@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_what_one_iteration_sends(world, mesh):
    """One Ulysses iteration on a 2- or 4-rank axis: the flip (one
    all_to_all), the initial objective (W gathered, one all_reduce), then
    W and H gathered and the objective reduced; the mesh= driver on its
    layout: the W half's X H^T and H H^T over 'cols', the H half's W^T X and
    W^T W over 'rows', the objective over every axis, the initial one too,
    the inits' minimum once over every axis and the factors gathered at
    the end."""
    _, ranks = world
    kinds = [str(k) for k in ranks[0]["calls/kinds"]]
    ulysses = dict(zip(kinds, same_on_every_rank(world, f"calls/ulysses/{mesh}").tolist()))
    assert ulysses == {"all_gather": 3, "all_reduce": 2, "all_to_all": 1, "broadcast": 0,
                       "p2p": 0}
    axes = len(_MESHES[mesh][0])
    per_iter = 4 if mesh == "m22" else 2
    mesh_calls = dict(zip(kinds, same_on_every_rank(world, f"calls/mesh/{mesh}").tolist()))
    assert mesh_calls == {"all_gather": axes, "all_reduce": axes + 2 * axes + per_iter,
                          "all_to_all": 0, "broadcast": 0, "p2p": 0}


# ---------------------------------------------------------------------------
# in this process: the surface, the device rule, what the worker imports
# ---------------------------------------------------------------------------

def test_the_port_exports_tpunmf_parallel_s_names():
    from tpunmf_torch import parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    # ntf_sharded takes tpunmf's (mesh, x, k): a world of one in this process
    import torch

    x = np.abs(np.random.default_rng(3).standard_normal((4, 5, 6)))
    init = [np.full((s, 2), 0.5) for s in x.shape]
    kw = dict(min_iter=3, max_iter=3, tol1=0.0, tol2=0.0, factors_init=init)
    got = tpar.ntf_sharded(tpar.build_mesh((1,), ("rows",), device_type="cpu"),
                           torch.from_numpy(x), 2, **kw)
    want = jpar.ntf_sharded(jpar.build_mesh((1,), ("rows",), devices=jax.devices()[:1]), x,
                            2, **kw)
    assert got.i == want.i
    np.testing.assert_allclose(got.obj_history, np.asarray(want.obj_history), rtol=1e-9)


def test_a_cuda_mesh_without_a_card_raises():
    import torch

    from tpunmf_torch import parallel as tpar

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        tpar.build_mesh()
    with pytest.raises(ValueError, match="device_type"):
        tpar.build_mesh(device_type="tpu")


@pytest.mark.parametrize("path", ["tests/_torch_dist_worker.py", "tools/multi_gpu.py",
                                  "tools/route_drift.py",
                                  "tests/_torch_dist_methods_worker.py",
                                  "tpunmf_torch/parallel/mesh_solvers.py",
                                  "tpunmf_torch/parallel/ntf_sharded.py",
                                  "tpunmf_torch/core/sums.py",
                                  "tpunmf_torch/parallel/mesh_checkpoint.py",
                                  "tpunmf_torch/io/checkpoint.py",
                                  "tpunmf_torch/bench.py",
                                  "tpunmf_torch/sweeps/run_configs.py",
                                  "tpunmf_torch/sweeps/bench_hals.py"])
def test_worker_and_tool_import_neither_jax_nor_tpunmf(path):
    import ast

    tree = ast.parse(open(os.path.join(os.path.dirname(_WORKER), "..", path)).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "jaxlib", "tpunmf")], names
