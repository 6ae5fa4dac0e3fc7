"""Readings that a cell's limits are set from, at the cell's own size.

    python3 nmfbench/calibrate.py --workload <cell> --seeds 12 --control 4 [--first-seed N]

For each seed: the cell's data; one fit of the timed path
(``harness.fits.fit``, the window's own call); the reference in float64
from the same init.  The program's numbers against it are the lower
readings.  On the first ``--control`` seeds, also the control (the
reference in float32 with TF32 products, ``reference/_prec.CONTROL``, in
the program's place) and the faults a fit can have: its state returned
unchanged, its updates stopped after half the iterations (the loop still
counting and reporting), half of X's columns left out, and one row of W
altered where it is produced; and the program's plain route
(``use_pallas=False``) as a second witness.  Each line printed is one
JSON object; the last is the summary: per number, the largest program
reading, the smallest control reading and each fault's smallest.  Not
run by the benchmark itself.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def as_result(w, h, trace, iterations):
    return SimpleNamespace(w=w.detach().cpu().numpy(), h=h.detach().cpu().numpy(),
                           i=iterations - 1, obj_history=list(trace))


def faults(cell, data, seed, ref, program):
    """The numbers of each fault against ``ref``."""
    import numpy as np
    import torch

    from nmfbench.harness import check, fits

    iterations = int(cell.traffic["iterations"])
    w0, h0 = fits.make_init(cell, data, seed, 0)
    out = {}
    unchanged = as_result(w0, h0, [ref[2][0]] * (iterations + 1), iterations)
    out["unchanged"] = check.gaps(cell, data, unchanged, ref)
    half_way = fits.fit(cell, data, w0, h0, iterations // 2)
    trace = list(half_way.obj_history)
    stalled = half_way._replace(i=iterations - 1,
                                obj_history=trace + trace[-1:] * (iterations + 1 - len(trace)))
    out["stalled"] = check.gaps(cell, data, stalled, ref)
    half = dict(data)
    half["x"] = data["x"].clone()
    half["x"][:, data["x"].shape[1] // 2:] = 0
    out["half"] = check.gaps(cell, data, fits.fit(cell, half, w0, h0, iterations), ref)
    w = np.array(program.w, copy=True)
    w[0] *= 2.0
    out["altered"] = check.gaps(cell, data, program._replace(w=w), ref)
    del half
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def readings(cell, seed: int, device: str, control: bool, underflow: bool = False) -> dict:
    """One seed's readings: the program, and where asked the control, the
    faults and the plain route; with ``underflow`` also against float64
    references whose factor entries below float32's least denormal or
    least normal number are 0 (float32's range, not its precision)."""
    import torch

    from nmfbench.harness import check, fits
    from nmfbench.reference._prec import CONTROL, Prec

    t = time.perf_counter()
    data = fits.make_data(cell, seed, device)
    iterations = int(cell.traffic["iterations"])
    w0, h0 = fits.make_init(cell, data, seed, 0)
    program = fits.fit(cell, data, w0, h0, iterations)
    ref = check.reference(cell, data, seed, 0)
    out = {"seed": seed, "program": check.gaps(cell, data, program, ref),
           "trace_gap": _trace_gaps(program.obj_history, ref[2]),
           "ref_trace": {str(t): float(ref[2][t]) for t in range(0, len(ref[2]), 25)},
           "zeros": _zeros(program.w, program.h, ref[0], ref[1])}
    if control:
        wc, hc, tc = check.reference(cell, data, seed, 0, prec=CONTROL)
        ctrl = as_result(wc, hc, tc, iterations)
        out["control"] = check.gaps(cell, data, ctrl, ref)
        out["control_trace_gap"] = _trace_gaps(tc, ref[2])
        plain = _plain_route(cell, data, w0, h0, iterations)
        out["plain"] = check.gaps(cell, data, plain, ref)
        out["plain_trace_gap"] = _trace_gaps(plain.obj_history, ref[2])
        out["faults"] = faults(cell, data, seed, ref, program)
    if underflow:
        for label, floor in (("denormal", float.fromhex("0x1p-150")),
                             ("normal", float(torch.finfo(torch.float32).smallest_normal))):
            flushed = check.reference(cell, data, seed, 0,
                                      prec=Prec(torch.float64, underflow=floor))
            out["ref_" + label] = check.gaps(cell, data, program, flushed)
            out["ref_" + label + "_trace_gap"] = _trace_gaps(program.obj_history, flushed[2])
            if control:
                out["control_vs_" + label] = check.gaps(cell, data, ctrl, flushed)
    out["seconds"] = time.perf_counter() - t
    del data, w0, h0
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _plain_route(cell, data, w0, h0, iterations):
    """The program's own plain route (``use_pallas=False``): a second
    witness beside the kernel route."""
    from nmfbench.harness import fits

    plain = dict(cell.traffic["factorize"], use_pallas=False)
    saved = cell.traffic
    cell.traffic = dict(saved, factorize=plain)
    try:
        return fits.fit(cell, data, w0, h0, iterations)
    finally:
        cell.traffic = saved


def _trace_gaps(trace, ref):
    """The objective's largest relative gap over iterations 0 .. t, for a
    few t, to see how it grows."""
    import numpy as np

    trace, ref = np.asarray(trace, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    gap = np.maximum.accumulate(np.abs(trace - ref) / np.abs(ref))
    return {str(t): float(gap[t]) for t in (1, 5, 10, 25, 50, 75, 100, 150, 200)
            if t < len(ref)}


def _zeros(w, h, w_ref, h_ref):
    """Entries that are 0 in the program's factors, and those of the
    reference's below float32's least normal number (1.2e-38)."""
    import numpy as np

    tiny = float(np.finfo(np.float32).tiny)
    return {"program_zeros": int((np.asarray(w) == 0).sum() + (np.asarray(h) == 0).sum()),
            "reference_below_f32": int((w_ref.abs() < tiny).sum() + (h_ref.abs() < tiny).sum())}


def summary(cell, lines: list) -> dict:
    from nmfbench.harness.check import NUMBERS

    out = {}
    for n in NUMBERS:
        prog = [r["program"][n] for r in lines]
        ctrl = [r["control"][n] for r in lines if "control" in r]
        out[n] = {"lower": max(prog), "median_program": sorted(prog)[len(prog) // 2],
                  "upper": min(ctrl) if ctrl else None,
                  "ratio": (min(ctrl) / max(prog)) if ctrl and max(prog) > 0 else math.inf,
                  "faults": {f: min(r["faults"][f][n] for r in lines if "faults" in r)
                             for f in (lines[0].get("faults") or {})}}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=4)
    p.add_argument("--first-seed", type=int, default=4_100_000_000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--underflow", type=int, default=0)
    args = p.parse_args(argv)
    from nmfbench.harness import spec

    cell = spec.resolve(spec.load_benchmark(), args.workload)
    lines = []
    for j in range(args.seeds):
        r = readings(cell, args.first_seed + 7919 * j, args.device, j < args.control,
                     bool(args.underflow))
        lines.append(r)
        print(json.dumps(r), flush=True)
    print(json.dumps({"cell": cell.name, "summary": summary(cell, lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
