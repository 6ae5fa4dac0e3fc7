"""The device's read rate, from a STREAM-style read probe (csrc/read_probe.cu).

``read_probe(x, s)`` is the kernel of ``bench.py``'s memory-rate probe
(bench.py:215-262): the (1, n) float32 column sums of X + s, m a multiple
of 128 (the TPU grid's strips), s a scalar that changes from call to call
so that no call can be elided.  On the card a call is one launch, with no
scratch and no second pass: each block sums a 32-column slab over all
rows in a fixed order.  ``read_rate(x)`` times it as ``bench.py`` does
(bench.py:264-299): the time of ``hi`` calls less that of ``lo`` calls,
over ``hi - lo``, taken with CUDA events, so the fixed cost of a run
cancels.

``read_probe`` takes its plain version (``read_probe_ref``) only for a
tensor on the CPU; for a CUDA tensor it launches its kernel or raises, and
counts its launches in ``read_probe.launches``.  ``read_rate`` measures
the card and raises for a CPU tensor.
"""
from __future__ import annotations

import torch

from ._launch import call, on_cpu

STRIP = 128  # rows of a strip, as the probe's grid (bench.py:229)


def read_probe_ref(x, s):
    """Plain version of :func:`read_probe`."""
    return torch.sum(x + s, 0, keepdim=True)


def _check(x):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"read_probe: x must be a 2-D float32 tensor, got {x.dim()}-D {x.dtype}")
    if x.shape[0] % STRIP:
        raise ValueError(f"read_probe: {STRIP} must divide m={x.shape[0]} "
                         "(the probe's grid reads whole strips)")


def read_probe(x, s):
    """The (1, n) float32 column sums of ``x + s``; ``x`` float32 (m, n)
    with m a multiple of 128, ``s`` a number or a one-element float32
    tensor (the kernel reads it from device memory)."""
    _check(x)
    if on_cpu(x):
        return read_probe_ref(x, s)
    if not x.is_contiguous():
        raise ValueError("read_probe: x must be contiguous")
    s = torch.as_tensor(s, dtype=torch.float32, device=x.device).reshape(())
    m, n = x.shape
    out = torch.empty((1, n), dtype=torch.float32, device=x.device)
    call("tpunmf_read_probe", x.device, x.data_ptr(), s.data_ptr(), m, n, out.data_ptr())
    read_probe.launches += 1
    return out


def read_rate(x, lo: int = 10, hi: int = 110) -> float:
    """Bytes per second that :func:`read_probe` reads from a CUDA ``x``:
    X's bytes times (hi - lo) over the time of hi calls less that of lo
    calls (each the better of two runs, after one warm-up run of each),
    every call with its own s, each result's first element added into a
    running sum as ``bench.py``'s loop does."""
    if x.device.type != "cuda":
        raise RuntimeError("read_rate measures a CUDA card: pass a CUDA tensor")
    s = torch.arange(hi, dtype=torch.float32, device=x.device)

    def seconds(calls):
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            acc += read_probe(x, s[i])[0, 0]
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    seconds(lo)
    seconds(hi)
    t_lo = min(seconds(lo), seconds(lo))
    t_hi = min(seconds(hi), seconds(hi))
    return x.numel() * x.element_size() * (hi - lo) / (t_hi - t_lo)


read_probe.launches = 0
