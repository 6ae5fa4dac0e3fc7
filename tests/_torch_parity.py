"""Shared helpers of the tpunmf_torch parity tests.

Inputs are made with numpy from a seed and handed to both packages:
``tpunmf`` (JAX on the CPU, x64 on, see conftest.py) and ``tpunmf_torch``
(PyTorch on the CPU, float64).  Under pytest-xdist each worker keeps torch
to one thread, so parallel workers do not oversubscribe the cores.
"""
from __future__ import annotations

import fcntl
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# f64 trace agreement between the packages: the same formulas with sums
# taken in another order (XLA vs ATen); observed ~1e-14, Gram objective
# ~1e-12 (it cancels ||X||^2 against the cross term)
TRACE_RTOL = 1e-10
# f32 kernel vs plain version, as tpunmf's own kernel tests (test_ops.py)
KERNEL_RTOL = 1e-5
SUM_RTOL = 1e-4
# the port's plain f32 route against tpunmf's float64 trace over a run (50
# iterations): chip_smoke.py's F64_PLAIN_FLOOR, the plain route's distance
# up to which a kernel route's gate on the card is 1e-5, twice this
PLAIN_F64_RTOL = 5e-6
F64_RUN = dict(min_iter=50, max_iter=50, tol1=0.0, tol2=0.0)


def lowrank(seed=42, m=60, n=48, k=5, noise=0.01):
    """The conftest ``lowrank_data`` matrix (exact low rank + noise floor)."""
    rng = np.random.default_rng(seed)
    w = rng.random((m, k))
    h = rng.random((k, n))
    return (w @ h + noise * rng.random((m, n))).astype(np.float64)


def kernel_problem(seed, m=64, n=128, k=16, zeros=False):
    """f32 (x, w, h) numpy arrays at tpunmf's kernel-test shape; with
    ``zeros`` about a fifth of X is exactly 0 (the KL masking path)."""
    rng = np.random.default_rng(seed)
    x = rng.random((m, n)).astype(np.float32)
    if zeros:
        x[x < 0.2] = 0.0
    w = (rng.random((m, k)) + 0.1).astype(np.float32)
    h = (rng.random((k, n)) + 0.1).astype(np.float32)
    return x, w, h


def masked_problem(seed, m=32, n=24, k=4, frac=0.6, weights=False):
    """f32 (x, mask, w, h) numpy arrays at tpunmf's masked kernel-test shape
    (tests/test_masked.py): a fully unobserved row 3 and column 5, and
    with ``weights`` a real-valued mask in [0.5, 2) on the observed cells."""
    rng = np.random.default_rng(seed)
    x = (rng.random((m, k)) @ rng.random((k, n)) + 0.05).astype(np.float32)
    mask = (rng.random((m, n)) < frac).astype(np.float32)
    mask[3, :] = 0.0
    mask[:, 5] = 0.0
    if weights:
        mask *= (0.5 + 1.5 * rng.random((m, n))).astype(np.float32)
    w = (rng.random((m, k)) + 0.1).astype(np.float32)
    h = (rng.random((k, n)) + 0.1).astype(np.float32)
    return x, mask, w, h


def f64_distance(got, want):
    """An f32 trace's largest relative distance from a float64 trace, over
    traces of one length."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got)), (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def f32(*arrays):
    """numpy arrays -> float32 CPU tensors (the port's f32 route)."""
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.float32)) for a in arrays)


def t(a):
    """numpy -> CPU tensor (a copy, so read-only JAX buffers are fine)."""
    return torch.from_numpy(np.array(a))


def assert_traces_match(got, want, rtol=TRACE_RTOL):
    """Objective traces agree iterate for iterate, NaN in the same places."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    real = ~np.isnan(want)
    np.testing.assert_allclose(got[real], want[real], rtol=rtol)


def assert_results_match(got, want, rtol):
    """Two solvers' Results agree: the same ``i`` and experiment, traces
    and factors within ``rtol`` (factors also within ``rtol`` of their
    largest entry, for the entries near 0)."""
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history, rtol=rtol)
    for a, b in ((got.w, want.w), (got.h, want.h)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())
    assert tuple(got.experiment) == tuple(want.experiment)


class Interrupt(Exception):
    pass


def run_interrupted(fn, path, every, blocks, **kw):
    """Run ``fn`` with checkpoints at ``path`` every ``every`` iterations
    and stop it after ``blocks`` blocks."""
    seen = []

    def stop(carry):
        seen.append(carry.i)
        if len(seen) >= blocks:
            raise Interrupt

    with pytest.raises(Interrupt):
        fn(checkpoint_path=path, checkpoint_every=every, on_block_end=stop, **kw)


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    return torch.device("cuda")


def one_rank_meshes(shape=(1,), names=("cols",)):
    """(tpunmf_torch, tpunmf) meshes of one rank each on the CPU (axis
    'cols', or ``shape`` and ``names``): the port's brings up a gloo world
    of one in this process."""
    import jax

    from tpunmf import parallel as jpar
    from tpunmf_torch import parallel as tpar

    return (tpar.build_mesh(shape, names, device_type="cpu"),
            jpar.build_mesh(shape, names, devices=jax.devices()[:1]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(worker, d, world, timeout):
    """Start ``world`` ranks of ``worker`` on ``d``/inputs.npz; None, or
    why the world failed."""
    port = _free_port()
    env = dict(os.environ, LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(world), str(port), str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        return f"the {world}-process gloo world did not finish in {timeout} s"
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0 or "WORKER_OK" not in out:
            return f"worker failed (rc={p.returncode}):\n{out}\n{err}"
    return None


def world_dir(tmp_path_factory, name):
    """The directory of the gloo world ``name``: its inputs, every rank's
    outputs and what the ranks wrote beside them (one for all xdist
    workers)."""
    base = tmp_path_factory.getbasetemp()
    d = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / name
    d.mkdir(exist_ok=True)
    return d


def gloo_world(tmp_path_factory, name, worker, inputs, world, timeout):
    """Inputs and every rank's outputs of one gloo world of ``worker``
    (a module's fixture).  Under xdist the first worker to need them runs
    the world, under a lock, and the others read its files; a world that
    hangs is killed at ``timeout`` and fails the test."""
    d = world_dir(tmp_path_factory, name)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "status").exists():
            np.savez(d / "inputs.npz", **inputs)
            status = _run_world(worker, d, world, timeout)
            if status and "address already in use" in status.lower():
                status = _run_world(worker, d, world, timeout)  # the port was taken
            (d / "status").write_text(status or "ok")
    status = (d / "status").read_text()
    if status != "ok":
        pytest.fail(status)
    return inputs, [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
