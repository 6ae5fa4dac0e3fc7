"""The reference solvers across 4 gloo processes against tpunmf's GSPMD runs.

One 4-process world a module (``world`` fixture, ``_torch_parity.gloo_world``):
the parent makes the inputs from a numpy seed, starts
``_torch_dist_methods_worker.py`` on 4 ranks, and each rank runs every case
at float64 through ``tpunmf_torch.NMF(x, k, mesh=...).factorize`` on CPU
meshes (2, 2) and (4,) 'cols' (every method, ``beta=``, ``multilevel=``,
MUR's objective keywords and ntf), ``parallel.ntf_sharded`` on a (4,)
'rows' mesh and ``mur_lambda_grid`` on a (4,) 'grid' mesh, then HALS's
checkpoints over (2, 2) through both backends.  Here every rank must
hold the same results, bit for bit, and they are held against ``tpunmf``
on a JAX mesh of the same shape over 4 of the 8 CPU devices, with
``tpunmf``'s own tolerances (tests/test_sharding.py:139-161,
tests/test_ntf.py:156-195, tests/test_cli.py:90-119).  The collective calls
of each run are held to ``chip_smoke.py``'s count of them.
"""
from __future__ import annotations

import importlib.util
import os

import jax
import numpy as np
import pytest

import torch

from tpunmf import NMF as JNMF
from tpunmf import parallel as jpar
from tpunmf.experiments import mur_lambda_grid as j_grid
from tpunmf.io import checkpoint as jcheckpoint
from tpunmf.solvers import common as jcommon
from tpunmf.solvers import ntf as jntf
from tpunmf_torch.io import load_state, load_state_dcp
from tpunmf_torch.solvers.common import init_carry

from _torch_dist_methods_worker import (CASES, CHECKPOINT, NTF_CASES, NTF_MESH_CASES, STOP,
                                        case_data, case_kwargs, ntf_kwargs)
from _torch_parity import gloo_world, world_dir

_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, "_torch_dist_methods_worker.py")
_WORLD = 4
_TIMEOUT = 180
_MESHES = {"m22": ((2, 2), ("rows", "cols")), "m4": ((4,), ("cols",)),
           "r4": ((4,), ("rows",)), "g4": ((4,), ("grid",))}
_CASES = {name: (method, options) for name, method, options in CASES}


def _inputs():
    rng = np.random.default_rng(2025)
    x = rng.random((16, 24)) + 0.05
    xkl = rng.random((16, 24))
    xkl[xkl < 0.25] = 0.0  # exact zeros: the KL masking
    out = dict(x=x, xkl=xkl, w0=rng.random((16, 4)) + 0.1, h0=rng.random((4, 24)) + 0.1,
               mask=rng.random((16, 24)) < 0.7,
               x3=np.abs(rng.standard_normal((16, 10, 6))),
               x15=np.abs(rng.standard_normal((15, 8, 4))),
               x16=np.abs(rng.standard_normal((16, 8, 4))))
    for m, s in enumerate((16, 10, 6)):
        out[f"f{m}"] = np.abs(rng.standard_normal((s, 3)))
    for m, s in enumerate((16, 8, 4)):
        out[f"g{m}"] = np.abs(rng.standard_normal((s, 2)))
    # semi-NMF's mixed-sign X; ntf's X of (8, 12, 5), its factors and mask
    out["xs"] = rng.standard_normal((16, 24))
    out["x3m"] = np.abs(rng.standard_normal((8, 12, 5)))
    for m, s in enumerate((8, 12, 5)):
        out[f"n{m}"] = np.abs(rng.standard_normal((s, 3)))
    out["mask3"] = rng.random((8, 12, 5)) < 0.7
    out["x40"] = rng.random((16, 40))  # a coarse level of 10 columns
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return gloo_world(tmp_path_factory, "torch_methods_world", _WORKER, _inputs(), _WORLD,
                      _TIMEOUT)


@pytest.fixture(scope="module")
def jmeshes():
    devices = jax.devices()[:_WORLD]
    return {name: jpar.build_mesh(shape, names, devices=devices)
            for name, (shape, names) in _MESHES.items()}


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_HERE, "..", "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def same_on_every_rank(world, key):
    _, ranks = world
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    return ranks[0][key]


@pytest.mark.parametrize("mesh", ["m22", "m4"])
@pytest.mark.parametrize("case", list(_CASES))
def test_facade_mesh_is_tpunmf_s_gspmd_run(world, jmeshes, case, mesh):
    """The same stopping iteration, traces within 1e-9, W and H within
    1e-7, and every rank the same bits."""
    inp, _ = world
    method, options = _CASES[case]
    kw = case_kwargs(options, inp)
    want = JNMF(case_data(options, kw, inp), 4, mesh=jmeshes[mesh]).factorize(method=method,
                                                                              **kw)
    key = f"{case}/{mesh}"
    i = int(same_on_every_rank(world, key + "/i"))
    assert i == want.i
    np.testing.assert_allclose(same_on_every_rank(world, key + "/obj"),
                               np.asarray(want.obj_history), rtol=1e-9)
    for f in ("w", "h"):
        np.testing.assert_allclose(same_on_every_rank(world, f"{key}/{f}"),
                                   np.asarray(getattr(want, f)), rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("mesh", ["m22", "m4"])
def test_orthogonality_residual_reads_all_reduced_grams(world, jmeshes, mesh):
    """ONMF's residual from each rank's columns of H, its Gram summed over
    'cols': tpunmf's residual of the whole H, on every rank."""
    from tpunmf.solvers.onmf import orthogonality_residual as j_residual

    inp, _ = world
    kw = case_kwargs(_CASES["onmf_h"][1], inp)
    want = JNMF(inp["x"], 4, mesh=jmeshes[mesh]).factorize(method="onmf", **kw)
    np.testing.assert_allclose(same_on_every_rank(world, f"onmf_h/{mesh}/orth"),
                               float(j_residual(want.h)), rtol=1e-9)


def test_some_runs_stop_early(world):
    """The stopping rule is exercised: at least one case of each family
    stops before max_iter on both meshes."""
    stopped = {name for name in _CASES
               if all(int(same_on_every_rank(world, f"{name}/{m}/i")) < STOP["max_iter"] - 1
                      for m in ("m22", "m4"))}
    families = {_CASES[name][0] + ("_mask" if "mask" in _CASES[name][1] else "")
                for name in stopped}
    assert {"hals", "anls", "admm", "ao_admm", "mur_mask"} <= families, stopped


@pytest.mark.parametrize("mesh", ["m22", "m4"])
@pytest.mark.parametrize("case", list(_CASES))
def test_what_each_run_sends(world, chip_smoke, case, mesh):
    """The collective calls of each run by kind, as chip_smoke.py counts
    them (with AO-ADMM's inner trips as the run took them)."""
    inp, ranks = world
    method, options = _CASES[case]
    kw = case_kwargs(options, inp)
    key = f"{case}/{mesh}"
    kinds = [str(k) for k in ranks[0]["calls/kinds"]]
    got = dict(zip(kinds, same_on_every_rank(world, key + "/calls").tolist()))
    trips = same_on_every_rank(world, key + "/trips").tolist()
    names = _MESHES[mesh][1]
    axes = dict(rows="rows" in names, cols="cols" in names)
    iters = int(same_on_every_rank(world, key + "/i")) + 1
    if "multilevel" in kw:
        want = chip_smoke.multilevel_calls(method, kw, iters=iters, n=inp["x"].shape[1], k=4,
                                           **axes)
    else:
        want = chip_smoke.mesh_method_calls(method, kw, iters=iters, trips=trips,
                                            kernels=False, **axes)
    assert got == want


@pytest.mark.parametrize("dist,update", NTF_CASES)
def test_ntf_sharded_matches_tpunmf(world, jmeshes, chip_smoke, dist, update):
    inp, ranks = world
    factors0 = [inp[f"f{m}"] for m in range(3)]
    kw = dict(distance_type=dist, update=update, min_iter=12, max_iter=12, tol1=0, tol2=0,
              factors_init=factors0)
    want = jpar.ntf_sharded(jmeshes["r4"], inp["x3"], 3, **kw)
    key = f"ntf/{dist}/{update}"
    assert int(same_on_every_rank(world, key + "/i")) == want.i
    np.testing.assert_allclose(same_on_every_rank(world, key + "/obj"),
                               np.asarray(want.obj_history), rtol=1e-9, atol=1e-9)
    for m in range(3):
        np.testing.assert_allclose(same_on_every_rank(world, f"{key}/f{m}"),
                                   np.asarray(want.factors[m]), rtol=1e-8, atol=1e-10)
    # and the one-device ntf, as tpunmf's own test holds its sharded run
    one = jntf(inp["x3"], 3, normalize=False, **kw)
    np.testing.assert_allclose(same_on_every_rank(world, key + "/obj"),
                               np.asarray(one.obj_history), rtol=1e-9, atol=1e-9)
    kinds = [str(k) for k in ranks[0]["calls/kinds"]]
    got = dict(zip(kinds, same_on_every_rank(world, key + "/calls").tolist()))
    assert got == chip_smoke.ntf_sharded_calls(dist, 3, 12, factors_given=True)


@pytest.mark.parametrize("mesh", ["m22", "m4"])
@pytest.mark.parametrize("case", [name for name, _ in NTF_MESH_CASES])
def test_facade_ntf_over_a_mesh_is_tpunmf_s(world, jmeshes, chip_smoke, case, mesh):
    """ntf through the facade's mesh= (modes 0 and 1 split, normalize=True):
    tpunmf's GSPMD run on the same mesh within its ntf tolerances, every
    rank the same bits, and the collective calls by formula."""
    inp, ranks = world
    kw = ntf_kwargs(dict(NTF_MESH_CASES)[case], inp)
    want = JNMF(inp["x3m"], 3, mesh=jmeshes[mesh]).factorize(method="ntf", **kw)
    key = f"ntf_mesh/{case}/{mesh}"
    i = int(same_on_every_rank(world, key + "/i"))
    assert i == want.i
    np.testing.assert_allclose(same_on_every_rank(world, key + "/obj"),
                               np.asarray(want.obj_history), rtol=1e-9, atol=1e-9)
    for m in range(3):
        np.testing.assert_allclose(same_on_every_rank(world, f"{key}/f{m}"),
                                   np.asarray(want.factors[m]), rtol=1e-8, atol=1e-10)
    kinds = [str(k) for k in ranks[0]["calls/kinds"]]
    got = dict(zip(kinds, same_on_every_rank(world, key + "/calls").tolist()))
    names = _MESHES[mesh][1]
    assert got == chip_smoke.ntf_mesh_calls(kw, "rows" in names, "cols" in names, 3, i + 1)


def test_multilevel_refuses_a_level_the_mesh_does_not_divide(world):
    """Where tpunmf's GSPMD run pads, the port's even blocks refuse, naming
    the level: X (16, 40) coarsened by 4 has 10 columns over 4 ranks."""
    got = str(same_on_every_rank(world, "ml_uneven"))
    assert got.startswith("multilevel level 1: X of shape (16, 10)") and "'cols'" in got


def _checkpoint_run(inp):
    kw = dict(CHECKPOINT, w_init=inp["w0"], h_init=inp["h0"])
    kw.pop("method")
    return kw


@pytest.mark.parametrize("backend", ["npz", "dcp"])
def test_a_mesh_checkpoint_resumes_bit_for_bit(world, jmeshes, chip_smoke, backend):
    """HALS over (2, 2) stopped after its first block of 5 and resumed
    gives the uninterrupted run's bits; resumed on the (4,) mesh instead,
    tpunmf's run within its tolerances; an .npz save gathers W and H."""
    inp, ranks = world
    full = {f: same_on_every_rank(world, f"ck/{backend}/full/{f}")
            for f in ("w", "h", "obj_history")}
    for f in ("w", "h", "obj_history"):
        np.testing.assert_array_equal(same_on_every_rank(world, f"ck/{backend}/resumed/{f}"),
                                      full[f], err_msg=f)
    kw = _checkpoint_run(inp)
    kw.pop("checkpoint_every")
    want = JNMF(inp["x"], 4, mesh=jmeshes["m22"]).factorize(method="hals", **kw)
    np.testing.assert_allclose(full["obj_history"], np.asarray(want.obj_history), rtol=1e-9)
    np.testing.assert_allclose(same_on_every_rank(world, f"ck/{backend}/moved/obj_history"),
                               np.asarray(want.obj_history), rtol=1e-9)
    np.testing.assert_allclose(same_on_every_rank(world, f"ck/{backend}/moved/w"),
                               np.asarray(want.w), rtol=1e-7, atol=1e-10)
    kinds = [str(k) for k in ranks[0]["calls/kinds"]]
    got = dict(zip(kinds, same_on_every_rank(world, f"ck/{backend}/full/calls").tolist()))
    assert got == chip_smoke.mesh_method_calls("hals", kw, True, True, 10,
                                               saves=2 if backend == "npz" else 0)


@pytest.mark.parametrize("backend", ["npz", "dcp"])
def test_a_sharded_checkpoint_loads_in_one_process(world, tmp_path_factory, backend):
    """The (2, 2) run's last checkpoint holds the global arrays: the port
    loads it in this one process (the .npz also into tpunmf's carry), and
    its W, H and trace are the run's."""
    inp, _ = world
    path = str(world_dir(tmp_path_factory, "torch_methods_world") / f"ck_{backend}_full")
    w0, h0 = torch.from_numpy(inp["w0"]), torch.from_numpy(inp["h0"])
    template = init_carry(torch.tensor(0.0, dtype=torch.float64), 10, (w0, h0))
    got = (load_state_dcp if backend == "dcp" else load_state)(path, template)
    assert got.i == 10
    for leaf, f in ((got.inner[0], "w"), (got.inner[1], "h")):
        np.testing.assert_array_equal(leaf.numpy(),
                                      same_on_every_rank(world, f"ck/{backend}/full/{f}"))
    np.testing.assert_array_equal(got.obj_buf.numpy(),
                                  same_on_every_rank(world, f"ck/{backend}/full/obj_history"))
    if backend == "npz":
        jt = jcommon.init_carry(np.float64(0.0), 10, (inp["w0"], inp["h0"]))
        back = jcheckpoint.load_state(path, jt)
        np.testing.assert_array_equal(np.asarray(back.inner[0]), got.inner[0].numpy())


@pytest.mark.parametrize("tag", ["divide", "kl_hals", "negative", "factors"])
def test_ntf_sharded_raises_tpunmf_s_errors(world, jmeshes, tag):
    inp, _ = world
    bad = [inp[f"g{m}"] for m in range(3)]
    bad[1] = bad[1][:, :1]
    args, kw, match = {"divide": ((inp["x15"], 2), {}, "divide"),
                       "kl_hals": ((inp["x16"], 2), dict(distance_type="kl", update="hals"),
                                   "least-squares"),
                       "negative": ((-inp["x16"], 2), {}, "non-negative"),
                       "factors": ((inp["x16"], 2), dict(factors_init=bad),
                                   "factors_init")}[tag]
    got = str(same_on_every_rank(world, f"ntf_error/{tag}"))
    assert match in got
    with pytest.raises(ValueError, match=match) as want:
        jpar.ntf_sharded(jmeshes["r4"], *args, **kw)
    assert got == str(want.value)


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_lambda_grid_over_a_mesh(world, jmeshes, chip_smoke, dist):
    """Every rank gets all four combinations: tpunmf's sharded grid and its
    unsharded one within 1e-6."""
    inp, ranks = world
    x = inp["x"] if dist == "eu" else inp["xkl"]
    kw = dict(lambda_w=(0.0, 0.1), lambda_h=(0.0, 0.05), n_iter=12, w_init=inp["w0"],
              h_init=inp["h0"], distance_type=dist)
    combos, ws, hs, objs = j_grid(x, 4, mesh=jmeshes["g4"], grid_axis="grid", **kw)
    combos1, ws1, _, objs1 = j_grid(x, 4, **kw)
    got = same_on_every_rank(world, f"grid/{dist}/combos")
    assert [tuple(c) for c in got.tolist()] == list(combos) == list(combos1)
    for want in (objs, objs1):
        np.testing.assert_allclose(same_on_every_rank(world, f"grid/{dist}/objs"),
                                   np.asarray(want), rtol=1e-6)
    for want in (ws, ws1):
        np.testing.assert_allclose(same_on_every_rank(world, f"grid/{dist}/ws"),
                                   np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(same_on_every_rank(world, f"grid/{dist}/hs"), np.asarray(hs),
                               rtol=1e-6)
    kinds = [str(k) for k in ranks[0]["calls/kinds"]]
    got_calls = dict(zip(kinds, same_on_every_rank(world, f"grid/{dist}/calls").tolist()))
    assert got_calls == chip_smoke.grid_calls(init_given=True)


def test_lambda_grid_refuses_an_indivisible_grid(world, jmeshes):
    with pytest.raises(ValueError) as want:
        j_grid(world[0]["x"], 4, lambda_w=(0.0, 0.1, 0.2), n_iter=2, mesh=jmeshes["g4"],
               grid_axis="grid")
    assert str(same_on_every_rank(world, "grid/indivisible")) == str(want.value)
