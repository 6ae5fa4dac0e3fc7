"""The traced run: ``torch.profiler`` (CUPTI) over a window of fits, and
its reduction to what the per-layer metrics read.

The window is the benchmark's own span ``nmfbench.window``.  Device
activity is every kernel, memcpy and memset interval on the card; busy
time is their union inside the window (not their sum), idle the rest.
Launches are the kernels that start inside the window.  Syncs are the
runtime and driver calls inside it that block the host until the device
is done (stream, event, context or device synchronisation and the
synchronous copies); PyTorch's read of a device value to the host is a
copy and a stream synchronisation, so it counts once.  Each idle gap is
put down to the innermost host operation running at its middle.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np

WINDOW = "nmfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SYNCS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpyPeer", "cudaMemcpyFromSymbol",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
    "cuMemcpyDtoH", "cuMemcpyDtoH_v2", "cuMemcpy", "cuMemcpy2D",
))
# gaps put down to a host operation one by one; the rest are summed
ATTRIBUTED_GAPS = 2000
TOP = 10


def capture(fn):
    """(fn()'s result, the trace's events) with CPU and, where there is a
    card, CUDA activities."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, events


def short_name(name: str) -> str:
    name = re.sub(r"^(void )?([\w:]+::)?(\(anonymous namespace\)::)?", "", name)
    return re.split(r"[<(]", name)[0][:64] or name[:64]


def union(intervals: np.ndarray) -> np.ndarray:
    """The union of (start, end) rows, as sorted disjoint rows."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def reduce(events: list) -> dict:
    """busy_s, window_s, kernels, syncs and the breakdown of a trace."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace holds no {WINDOW} span")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and float(e["ts"]) < w1 and float(e["ts"]) + float(e.get("dur", 0)) > w0]
    iv = np.asarray([[max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)]
                     for e in device], dtype=np.float64).reshape(-1, 2)
    busy = union(iv)
    busy_us = float(np.sum(busy[:, 1] - busy[:, 0])) if len(busy) else 0.0
    kernels = sum(1 for e in device if e["cat"] == "kernel" and float(e["ts"]) >= w0)
    syncs = sum(1 for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name") in SYNCS and w0 <= float(e["ts"]) < w1)

    by_op = {}
    for e in device:
        key = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        by_op[key] = by_op.get(key, 0.0) + float(e["dur"]) * 1e-6
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]

    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6, "kernels": kernels,
            "syncs": syncs,
            "breakdown": {"device_ops": [[k, v] for k, v in device_ops],
                          "idle_gaps": _gaps_by_host(events, gaps, w0, w1)}}


def _gaps_by_host(events, gaps, w0, w1) -> list:
    """Idle seconds by the innermost host operation at each gap's middle."""
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW and float(e["ts"]) < w1
            and float(e["ts"]) + float(e.get("dur", 0)) > w0]
    starts = np.asarray([float(e["ts"]) for e in host])
    ends = starts + np.asarray([float(e.get("dur", 0)) for e in host])
    names = [e["name"] for e in host]
    order = np.argsort(-(gaps[:, 1] - gaps[:, 0]))
    totals = {}
    for j, g in enumerate(order):
        s, e = gaps[g]
        if j >= ATTRIBUTED_GAPS:
            key = "(shorter gaps)"
        else:
            mid = 0.5 * (s + e)
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            key = (names[inside[np.argmin(ends[inside] - starts[inside])]][:64]
                   if len(inside) else "(no host operation)")
        totals[key] = totals.get(key, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
