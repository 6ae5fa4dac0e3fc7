"""The sweep scripts' kernels and loops, and bench.py's read probe, in the port.

``benchmarks/sweep_iter2.py`` (``v1_iter``, ``v2_iter``, ``make_v1``,
``make_v2``) and ``benchmarks/sweep_int8.py`` (``iter_eu_int8``,
``make_run``) are loaded by file path with their Pallas calls in interpret
mode (their module attribute ``pl`` replaced by a namespace whose
``pallas_call`` passes ``interpret=True``, and ``sweep_int8``'s import-time
``enable_compilation_cache`` made a no-op); nothing in ``benchmarks/`` is
edited.  The same numpy inputs go through them and through
``tpunmf_torch.ops.mur_variants`` and ``tpunmf_torch.sweeps``, whose
wrappers take their plain versions on the CPU.  ``bench.py``'s probe runs
only on a TPU backend (bench.py:217), so the probe's plain version is held
to its formula.  The CUDA kernels run only on the card
(tests/test_torch_cuda.py).
"""
import functools
import importlib.util
import os
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tpunmf.utils
from _torch_parity import KERNEL_RTOL, kernel_problem, t
from tpunmf.ops import mur_fused as jmur_fused
from tpunmf_torch.ops import mur_fused, mur_variants, read_probe
from tpunmf_torch.sweeps import sweep_int8, sweep_iter2

BENCHMARKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "benchmarks")
BM = 32  # 64 x 128 X in 2 strips
# the loops at bf16 X (and int8 X, multiplied in bf16): W' is rounded to bf16
# before each W'^T X, and the two sides' W' differ by f32 summation order, so
# a W' entry next to a bf16 rounding boundary lands on either side and moves
# its wtx terms by up to 2^-8 relative; five iterations carry that on
LOOP_RTOL = {"float32": 1e-5, "bfloat16": 1e-4}
# the int8 loop's factors elementwise, for that reason: 3.2e-4 observed on H
INT8_FACTOR_RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def script(name):
    """benchmarks/<name>.py, its Pallas kernels run in interpret mode."""
    spec = importlib.util.spec_from_file_location(f"_benchmarks_{name}",
                                                  os.path.join(BENCHMARKS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    # sweep_int8.py turns on JAX's persistent compilation cache when imported
    with mock.patch.object(tpunmf.utils, "enable_compilation_cache", lambda *a, **k: None):
        spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(BlockSpec=pl.BlockSpec, program_id=pl.program_id,
                                   when=pl.when,
                                   pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


def quantized(seed, shift=0.0):
    """kernel_problem's (X - shift) quantised as sweep_int8.py:101-103:
    (x, xq int8, scale f32, w, h) as numpy."""
    x, w, h = kernel_problem(seed)
    x = x - np.float32(shift)
    scale = np.float32(np.abs(x).max() / 127.0)
    xq = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return x, xq, scale, w, h


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, dtype=np.float64)


def _scaled_err(got, want):
    return float(np.max(np.abs(_np(got) - _np(want))) / np.max(np.abs(_np(want))))


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["v1_iter", "v2_iter"])
def test_v_plain_versions_match_the_script_kernels(name, xdtype):
    x, w, h = kernel_problem(50)
    want = getattr(script("sweep_iter2"), name)(jnp.asarray(x).astype(getattr(jnp, xdtype)),
                                                jnp.asarray(w), jnp.asarray(h), BM)
    fn = getattr(mur_variants, name)
    before = fn.launches
    got = fn(t(x).to(getattr(torch, xdtype)), t(w), t(h), BM)
    assert fn.launches == before  # CPU: the plain version
    # bf16 X too: both sides round H^T and W' to bf16 in the products
    # (observed 7.4e-7 at f32, 5.1e-7 at bf16)
    assert len(got) == len(want)
    for g, j in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=KERNEL_RTOL)


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_int8_plain_version_matches_the_script_kernel(shift):
    """X >= 0, and X with negative values (shift 0.5): int8 X carries a sign."""
    _, xq, scale, w, h = quantized(51, shift)
    assert (xq < 0).any() == (shift > 0)
    want = script("sweep_int8").iter_eu_int8(jnp.asarray(xq), jnp.float32(scale),
                                             jnp.asarray(w), jnp.asarray(h), BM)
    before = mur_variants.iter_eu_int8.launches
    got = mur_variants.iter_eu_int8(t(xq), torch.tensor(scale), t(w), t(h), BM)
    assert mur_variants.iter_eu_int8.launches == before
    for g, j in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == j.shape
        if shift == 0.0:  # sums of positive terms: f32 rounding in another order
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=KERNEL_RTOL)
        else:  # signed sums cancel, so held to max |got - want| / max |want|
            assert _scaled_err(g, j) <= KERNEL_RTOL


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("make", ["make_v1", "make_v2"])
def test_sweep_loops_match_the_script_loops(make, xdtype):
    """Five iterations of the scripts' jitted loops (sweep_iter2.py:133-155)
    and the port's, from the same init: their scalar sum(W[0]) + sum(H[:, 0])."""
    x, w, h = kernel_problem(52)
    want = getattr(script("sweep_iter2"), make)(BM)(
        jnp.asarray(x).astype(getattr(jnp, xdtype)), jnp.asarray(w), jnp.asarray(h), 5)
    got = getattr(sweep_iter2, make)(BM)(t(x).to(getattr(torch, xdtype)), t(w), t(h), 5)
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOOP_RTOL[xdtype])


def test_int8_loop_matches_the_script_loop():
    """Five iterations of sweep_int8.py's make_run (:78-89) and the port's:
    the factors and the scalar."""
    _, xq, scale, w, h = quantized(52)
    want = script("sweep_int8").make_run(BM)(jnp.asarray(xq), jnp.float32(scale),
                                             jnp.asarray(w), jnp.asarray(h), 5)
    got = sweep_int8.make_run(BM)(t(xq), torch.tensor(scale), t(w), t(h), 5)
    for g, j in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=INT8_FACTOR_RTOL)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=LOOP_RTOL["bfloat16"])


def test_f32_reference_loop_matches_tpunmf_s():
    """sweep_int8's f32 loop (sweep_int8.py:123-132) built from tpunmf's
    rule and its mur_iteration_eu in interpret mode, against the port's."""
    x, w, h = kernel_problem(53)
    xj, wj, hj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(h)
    bm = jmur_fused.iter_eu_tileable(xj, 16)
    assert bm == mur_fused.iter_eu_tileable(t(x), 16) == 64
    for _ in range(5):
        wj, wtx, gw = jmur_fused.mur_iteration_eu(xj, wj, hj, lam_w=0.0, bm=bm, interpret=True)
        hj = hj * wtx / (gw @ hj + 1e-9)
    got = sweep_int8.run_f32(t(x), t(w), t(h), 5)
    for g, j in zip(got, (wj, hj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=LOOP_RTOL["float32"])


def test_quantize_is_the_script_s():
    x, xq, scale, _, _ = quantized(54, shift=0.3)
    got_q, got_s = sweep_int8.quantize(t(x))
    assert got_q.dtype == torch.int8 and got_s.dim() == 0
    np.testing.assert_array_equal(got_q.numpy(), xq)
    assert float(got_s) == float(scale)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_v1_plain_version_is_mur_iteration_eu_s_at_lam_0(xdtype):
    x, w, h = kernel_problem(55)
    xt = t(x).to(getattr(torch, xdtype))
    got = mur_variants.v1_iter_ref(xt, t(w), t(h))
    want = mur_fused.mur_iteration_eu_ref(xt, t(w), t(h), lam_w=0.0)
    assert all(torch.equal(g, j) for g, j in zip(got, want))
    v2 = mur_variants.v2_iter_ref(xt, t(w), t(h))
    assert all(torch.equal(g, j) for g, j in zip((v2[0], v2[2], v2[3]), got))


# three values of s at 256x100, then 0.25 at the shapes the card tests run
# (n % 4 != 0, a slab past n, one strip)
@pytest.mark.parametrize("s,m,n", [
    (0.0, 256, 100), (3.0, 256, 100), (torch.tensor([[-1.5]]), 256, 100),
    (0.25, 896, 777), (0.25, 128, 1), (0.25, 384, 1000), (0.25, 1024, 64)],
    ids=["0.0", "3.0", "s2", "896x777", "128x1", "384x1000", "1024x64"])
def test_read_probe_plain_version_is_its_formula(s, m, n):
    """bench.py:237: the column sums of X + s over the strips, (1, n) f32."""
    x = np.random.default_rng(56).random((m, n)).astype(np.float32)
    before = read_probe.read_probe.launches
    got = read_probe.read_probe(t(x), s)
    assert read_probe.read_probe.launches == before
    assert got.shape == (1, n) and got.dtype == torch.float32
    want = np.sum(x.astype(np.float64) + float(s), axis=0, keepdims=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_RTOL)


def test_read_probe_checks_its_strips_and_type():
    with pytest.raises(ValueError, match="128 must divide m=200"):
        read_probe.read_probe(torch.ones((200, 8)), 0.0)
    with pytest.raises(TypeError):
        read_probe.read_probe(torch.ones((128, 8), dtype=torch.bfloat16), 0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        read_probe.read_rate(torch.ones((128, 8)))


@pytest.mark.parametrize("name", ["v1_iter", "v2_iter", "iter_eu_int8"])
def test_variant_wrappers_refuse_what_the_scripts_cannot_run(name):
    """A strip height that does not divide m (the scripts' grids would drop
    the last rows), and dtypes the scripts' kernels do not take."""
    x, xq, scale, w, h = (t(a) for a in quantized(57))
    fn = getattr(mur_variants, name)

    def call(xx, ww=w, hh=h, bm=BM):
        return fn(xx, scale, ww, hh, bm) if name == "iter_eu_int8" else fn(xx, ww, hh, bm)

    good = xq if name == "iter_eu_int8" else x
    with pytest.raises(ValueError, match="bm=48 must divide m=64"):
        call(good, bm=48)
    for bad in (x.double(), xq if name != "iter_eu_int8" else x):
        with pytest.raises(TypeError, match="x must be"):
            call(bad)
    with pytest.raises(TypeError, match="factors must be float32"):
        call(good, ww=w.double(), hh=h.double())


@pytest.mark.parametrize("module", [sweep_iter2, sweep_int8])
def test_sweep_scripts_need_a_card(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
