"""Run one cell of BENCHMARK.json on one NVIDIA H100.

    python3 nmfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the start of this process): import torch and
tpunmf_torch, load the kernel library (``tpunmf_torch/ops/_build/``, built
there by nvcc on a checkout's first run), make the configuration's data
on the card from the seed, and warm up with one short fit of the cell's
own shapes.  The window: whole fits in a closed loop, one at a time,
until the first to finish after ``--seconds``; ``fit_it_per_s`` is their
iterations over the window's seconds.  With ``--trace 1`` the window is
the traffic's ``trace_fits`` fits under ``torch.profiler``, and the line
holds the per-layer metrics, ``busy_s``, ``window_s`` and the breakdown.
Then a sample of the fits, drawn from the seed, is compared with the
method's plain reference in float64 (``harness/check.py``); each number
and its limit end standard error and the result line.

The last line of standard output is the result, one JSON object.
Without a CUDA device, with fewer than the cell's cards, without
tpunmf_torch, or with jax, jaxlib, flax or tpunmf loaded once the window
has closed, it exits with a code other than 0 and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "tpunmf"))


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the benchmark may not load,
    compared whole (``tpunmf_torch`` is not ``tpunmf``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_state():
    """nvidia-smi's name, power limit, SM clock, power draw and temperature,
    or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def log(**fields):
    print("nmfbench " + json.dumps(fields), file=sys.stderr, flush=True)


def _plain(v):
    return v if isinstance(v, (int, str)) or math.isfinite(v) else str(v)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = T0) -> dict:
    """Set-up, window and check of one cell; the result line's object."""
    import torch

    from nmfbench.harness import check, fits, peaks
    from nmfbench.harness import trace as tracing
    from nmfbench.harness.spec import load_module

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [("imports_s", time.perf_counter())]
    if cuda:
        from tpunmf_torch.ops import _build

        _build.library()
        marks.append(("kernel_library_s", time.perf_counter()))
    data = fits.make_data(cell, seed, device)
    sync()
    marks.append(("data_s", time.perf_counter()))
    w0, h0 = fits.make_init(cell, data, seed, -1)
    fits.fit(cell, data, w0, h0, int(cell.traffic["warmup_iterations"]))
    del w0, h0
    sync()
    marks.append(("warmup_s", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    log(setup_parts={name: t - before for (name, t), before
                     in zip(marks, [t0] + [t for _, t in marks[:-1]])})
    if cuda:
        log(card_before=card_state())

    iterations = int(cell.traffic["iterations"])
    if trace:
        from torch.profiler import record_function

        def body():
            with record_function(tracing.WINDOW):
                out = fits.window(cell, data, seed, seconds,
                                  max_fits=int(cell.traffic["trace_fits"]),
                                  span=record_function)
                sync()
                return out

        (results, elapsed, each, error), events = tracing.capture(body)
    else:
        results, elapsed, each, error = fits.window(cell, data, seed, seconds)
    sync()
    memory_peak = torch.cuda.max_memory_allocated(0) if cuda else 0
    done = len(results) * iterations
    if cuda:
        log(card_after=card_state(), memory_peak_bytes=memory_peak, fits=len(results),
            iterations=done, window_s=elapsed, fit_s=sorted(each))
    if error is not None:
        log(fit_error=repr(error))

    metrics, breakdown = {}, None
    if trace:
        reduced = tracing.reduce(events)
        del events
        m, n = data["x"].shape
        work = cell.work().per_iteration(m, n, cell.rank, x_bytes=data["x"].element_size())
        ctx = dict(reduced, iterations=done, work=work, bound_s=peaks.bound_s(work))
        log(trace={k: v for k, v in ctx.items() if k != "breakdown"},
            bound_by=peaks.bound_by(work))
        for metric in cell.per_layer:
            value = load_module("metrics", metric["name"]).read(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        breakdown = reduced["breakdown"]
    else:
        ctx = {"setup_s": setup_s, "window_s": elapsed, "iterations": done,
               "fits": len(results), "fit_s": each}
        for metric in cell.end_to_end:
            value = load_module("metrics", metric["name"]).read(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}

    # the reference runs once the window has closed and the peak is read
    if cuda:
        torch.cuda.empty_cache()
    if results:
        numbers, failed = check.check(cell, data, seed, results)
    else:
        numbers, failed = {n: math.inf for n in cell.limits}, 0
    failed += error is not None
    correct = error is None and bool(results) and not check.breaks(cell, numbers)

    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if trace:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    result = {"correct": correct, "attempted": len(results) + (error is not None),
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": _plain(numbers[n]), "limit": limit}
                        for n, limit in cell.limits.items()}
    for n, limit in cell.limits.items():
        print(f"check {n} {numbers[n]!r} limit {limit!r}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from nmfbench.harness import spec

    try:
        cell = spec.resolve(spec.load_benchmark(), args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"nmfbench: {exc}", file=sys.stderr)
        return 2
    import torch

    # one thread of host work beside the loop: the program's host side is
    # its loop and scalar reads, and spare threads only add jitter
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("nmfbench: no CUDA device (torch.cuda.is_available() is False); the benchmark "
              "measures tpunmf_torch on an NVIDIA GPU and does not fall back to the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"nmfbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import tpunmf_torch  # noqa: F401
    except ImportError as exc:
        print(f"nmfbench: the program under test, tpunmf_torch, is missing: {exc}",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"nmfbench: modules the benchmark may not load are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
