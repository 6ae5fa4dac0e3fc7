"""Inputs from the seed, and the timed path: whole fits of
``tpunmf_torch.NMF(X, k).factorize(...)``, one at a time.

A fit takes the cell's method and keywords, an init (W0, H0) drawn on the
device from (seed, fit index), and ``min_iter = max_iter``, so that no fit
stops early and every fit does the same work.  The facade's host loop,
its objective read every iteration and its copy of W and H to the host
are inside, as a user pays them.
"""
from __future__ import annotations

import contextlib
import hashlib
import math
import os
import time

import torch


def derive(seed: int, *parts) -> int:
    """A 63-bit generator seed for (seed, parts): the same for the same
    arguments, unrelated for different ones."""
    digest = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, *parts) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, *parts))
    return gen


def make_data(cell, seed: int, device) -> dict:
    """The configuration's inputs from ``seed``, on ``device``, with
    ``init_scale``: 2 sqrt(mean / k), the mean over the observed entries,
    so that W0 H0 is about the data's mean."""
    data = cell.generator().make(cell.config, generator(device, seed, "data"), device)
    x = data["x"]
    if "mask" in data:
        mean = float(x.sum(dtype=torch.float64) / data["mask"].sum())
    else:
        mean = float(x.mean(dtype=torch.float64))
    data["init_scale"] = 2.0 * math.sqrt(mean / cell.rank)
    return data


def make_init(cell, data: dict, seed: int, index: int):
    """(W0, H0), uniform on [0, init_scale), on X's device, from (seed,
    fit index)."""
    x = data["x"]
    m, n = x.shape
    k = cell.rank
    gen = generator(x.device, seed, "init", int(index))
    w0 = torch.rand((m, k), generator=gen, dtype=torch.float32, device=x.device)
    h0 = torch.rand((k, n), generator=gen, dtype=torch.float32, device=x.device)
    return w0.mul_(data["init_scale"]), h0.mul_(data["init_scale"])


def fit(cell, data: dict, w0, h0, iterations: int):
    """One fit on the timed path: the program's ``Results``."""
    import tpunmf_torch

    kw = dict(cell.traffic["factorize"])
    kw.update(min_iter=iterations, max_iter=iterations, w_init=w0, h_init=h0)
    if cell.traffic.get("mask"):
        kw["mask"] = data["mask"]
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        return tpunmf_torch.NMF(data["x"], cell.rank).factorize(**kw)


def window(cell, data: dict, seed: int, seconds: float, *, max_fits=None, span=None):
    """Fits in a closed loop until the first to finish after ``seconds``
    (or ``max_fits`` fits).  Returns (results, elapsed seconds, each fit's
    seconds, error): ``error`` is the exception a fit raised, which ends
    the window."""
    iterations = int(cell.traffic["iterations"])
    span = span or (lambda name: contextlib.nullcontext())
    results, ends, error = [], [], None
    t0 = time.perf_counter()
    while True:
        try:
            with span("nmfbench.fit"):
                w0, h0 = make_init(cell, data, seed, len(results))
                results.append(fit(cell, data, w0, h0, iterations))
        except Exception as exc:  # a fit that raises is a failed answer
            error = exc
            break
        ends.append(time.perf_counter() - t0)
        if max_fits is not None and len(results) >= max_fits:
            break
        if max_fits is None and ends[-1] >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return results, elapsed, [b - a for a, b in zip([0.0] + ends, ends)], error
