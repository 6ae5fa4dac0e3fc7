"""Whether the timed path's fits are right: a sample of them, drawn from
the seed, against the method's plain reference in float64.

The numbers, each the worst over the sampled fits; a cell compares those
its ``limits/<cell>.json`` lists:

- ``iters``: how far the fit's iteration count and trace length are from
  the traffic's (exact: limit 0);
- ``obj_gap``: the largest relative gap of the objective trace from the
  reference's, max_t |obj_t - ref_t| / |ref_t|, over t = 0 ..
  ``obj_gap_iterations`` (all of them unless the file says fewer);
- ``obj_gap_all``: the same over the whole trace, t = 0 .. the last;
- ``w_gap``, ``h_gap``: ||W - W_ref||_F / ||W_ref||_F, and the same of H;
- ``wh_gap``: ||M * (W H - W_ref H_ref)||_F / ||M * W_ref H_ref||_F, M the
  cell's mask or all ones: the fitted values, blind to the rescalings
  W D, D^-1 H that leave them unchanged;
- ``final_obj_gap``: the fit's last reported objective against the
  reference's objective of the W and H the fit returned, relative: the
  answer agrees with what the program says of it.

The reference runs on the inputs the benchmark made (X, the mask, W0 and
H0 drawn again from the seed), never on anything the program derived.
"""
from __future__ import annotations

import math
import random

import numpy as np
import torch

from . import fits
from ..reference._prec import F64, row_blocks

NUMBERS = ("iters", "obj_gap", "obj_gap_all", "w_gap", "h_gap", "wh_gap",
           "final_obj_gap")


def sample(seed: int, count: int, wanted: int) -> list:
    """Indices of ``wanted`` of ``count`` fits, drawn from the seed."""
    rng = random.Random(fits.derive(seed, "sample"))
    return sorted(rng.sample(range(count), min(wanted, count)))


def _rel(a, b) -> float:
    a = torch.as_tensor(np.asarray(a), dtype=torch.float64, device=b.device)
    b = b.to(torch.float64)
    g = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    return g if math.isfinite(g) else math.inf


def _gap(a, b) -> float:
    g = abs(float(a) - float(b)) / abs(float(b))
    return g if math.isfinite(g) else math.inf


def gaps(cell, data: dict, result, ref) -> dict:
    """The numbers of one fit (``w``, ``h``, ``i``, ``obj_history``)
    against the reference's (W, H, trace)."""
    iterations = int(cell.traffic["iterations"])
    upto = int(cell.check.get("obj_gap_iterations", iterations))
    w_ref, h_ref, trace_ref = ref
    trace = np.asarray(result.obj_history, dtype=np.float64)
    out = {"iters": float(abs(int(result.i) - (iterations - 1))
                          + abs(len(trace) - (iterations + 1)))}
    if len(trace) != len(trace_ref):
        return dict(out, **{n: math.inf for n in NUMBERS[1:]})
    each = [_gap(a, b) for a, b in zip(trace, trace_ref)]
    out["obj_gap"] = max(each[:upto + 1])
    out["obj_gap_all"] = max(each)
    out["w_gap"] = _rel(result.w, w_ref)
    out["h_gap"] = _rel(result.h, h_ref)
    x = data["x"]
    w = torch.as_tensor(np.asarray(result.w), device=x.device)
    h = torch.as_tensor(np.asarray(result.h), device=x.device)
    out["wh_gap"] = _fitted_gap(w, h, w_ref, h_ref, _mask(cell, data))
    own = cell.reference().objective(x, w, h, mask=_mask(cell, data))
    out["final_obj_gap"] = _gap(trace[-1], own)
    return out


def _fitted_gap(w, h, w_ref, h_ref, mask) -> float:
    """||M * (W H - W_ref H_ref)||_F / ||M * W_ref H_ref||_F in float64, X's
    rows in blocks."""
    w, h, w_ref, h_ref = (t.to(torch.float64) for t in (w, h, w_ref, h_ref))
    num = den = 0.0
    for b in row_blocks(w.shape[0], h.shape[1]):
        ref = w_ref[b] @ h_ref
        diff = w[b] @ h - ref
        if mask is not None:
            mb = mask[b].to(torch.float64)
            ref, diff = ref * mb, diff * mb
        num += float(torch.sum(diff * diff))
        den += float(torch.sum(ref * ref))
    g = math.sqrt(num / den) if den > 0 else math.inf
    return g if math.isfinite(g) else math.inf


def _mask(cell, data):
    return data.get("mask") if cell.traffic.get("mask") else None


def reference(cell, data: dict, seed: int, index: int, prec=F64):
    """The reference's (W, H, trace) of fit ``index``."""
    w0, h0 = fits.make_init(cell, data, seed, index)
    return cell.reference().run(
        data["x"], w0, h0, iterations=int(cell.traffic["iterations"]),
        params=cell.traffic["factorize"], mask=_mask(cell, data), prec=prec)


def breaks(cell, numbers: dict) -> bool:
    return any(not numbers[n] <= limit for n, limit in cell.limits.items())


def check(cell, data: dict, seed: int, results: list) -> tuple[dict, int]:
    """(the worst of each compared number over the sampled fits, how many
    of them broke a limit)."""
    worst = {n: 0.0 for n in cell.limits}
    failed = 0
    for index in sample(seed, len(results), int(cell.traffic["check_fits"])):
        numbers = gaps(cell, data, results[index], reference(cell, data, seed, index))
        for n in worst:
            worst[n] = max(worst[n], numbers[n])
        failed += breaks(cell, numbers)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return worst, failed
