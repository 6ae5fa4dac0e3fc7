"""Benchmark: MUR iterations/s and GFLOP/s on one H100, as ``bench.py`` reports them.

The port of the repository's ``bench.py`` (``python -m tpunmf_torch bench``
runs :func:`main`).  Headline: the MUR EU iteration at 8192 x 8192 rank 128
with bfloat16 X (factors float32), driven through the port's solver loop
(``solvers/mur.py::_mur_block``, Gram objective) on the route
``mur_route`` picks for it: the single pass (``mur_iteration_eu``) at that
shape.  The float32-X run, rank 512 at 8192 x 2048, MUR KL with the lagged
objective (every iteration, and every 8th), top-k serving at (64, 2^20)
r128 and (64, 2^19) r512, and the iteration rates of eight solver families
are reported beside it in ``extra``.

Accounting.  ``vs_baseline`` is the fraction of the roofline iteration
time achieved, over BASELINE.json's 0.70 target:

    t_roofline = max(bytes_iter / BW, flops_iter / bf16_peak)

The peaks are the H100 SXM's nominal rates (``ops/roofline.py``); any
other card raises.  BW is measured: solver-independent probes (the
read-probe kernel ``ops/read_probe.py``, ``torch.sum`` of X, an in-place
read+write stream, a float32 GEMM against X, and a chained bfloat16 GEMM
for the product ceiling) are sampled before, between and after the solver
benches, each delta-timed.  A memory sample above the card's nominal
3.35 TB/s is discarded, not capped, and so is a product sample above
1.25 x the nominal bf16 peak.  The ceiling is the best memory probe of
this run, capped at the nominal; nothing is read from or kept on disk, so
no run's ceiling depends on an earlier run.  It is never the solver's own
rate: if the solver moves bytes faster than every probe, the line says
``probes_undershoot_solver`` and the headline falls back to the
nominal-rate fraction.  bytes_iter counts only the required traffic (X
read once a pass, W and H read and written, WtX written and read).

Timing: every end point is a host read, which waits for the card, and
every rate is a two-point delta (the time of a long run less that of a
short one), so fixed per-call costs cancel.  The port's solver loops read
the objective to the host once an iteration (``solvers/common.py``), and
that read is inside every rate, as it is in every run of the solvers.

The ``bench_*`` functions run on the card unless given ``device="cpu"``
(the tests); :func:`main` needs an H100 and raises without one.  A
sub-bench that raises is recorded as ``{"error": ...}`` in its place, so
the line keeps its shape; after printing, :func:`main` then raises.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
"""
from __future__ import annotations

import json
import sys
import time
import traceback

import torch

from .core.precision import full_f32
from .ops.read_probe import read_probe
from .ops.roofline import PEAK_BF16, PEAK_BYTES
from .serve.topk import _quantized_rerank, recall_at_k, topk_scores_dense
from .solvers.common import init_carry
from .solvers.mur import _EPS, _mur_block, _passes, mur_route

# a product sample above this multiple of the nominal bf16 peak is a
# timing artifact, not evidence of the card's rate, and is discarded
_MXU_SANITY = 1.25

# BASELINE.json's target: 70% of the roofline
_TARGET = 0.70

# extra iterations of each family's long run in bench_solver_rates, as
# bench.py has them; a module-level table so that tests can shrink them
RATE_DELTAS = {"mur_kl": 4000, "mur_eu": 8000, "mur_masked_eu": 6000, "hals": 8000,
               "anls": 500, "admm": 3000, "ao_admm": 2000, "ao_admm_local_l1inf": 1000}


def _card_name() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; the bench measures an H100 and "
                           "never runs on the CPU")
    return torch.cuda.get_device_name(0)


def _chip_limits() -> tuple[float, float]:
    """(bf16 product peak FLOP/s, memory bytes/s) of the card: the H100
    SXM's nominal rates.  Another card raises: its rates are not known
    here, and a wrong nominal would misplace every fraction."""
    name = _card_name()
    if "H100" not in name:
        raise RuntimeError(f"bench: no nominal rates for {name!r}; the bench knows the H100's")
    return PEAK_BF16, PEAK_BYTES


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _timeit(fn, *args, reps=3):
    """Best-of-reps wall time; host-fetch inside the timed region."""
    float(fn(*args))  # warm-up (compile + one run)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _refraction(r, bw):
    """Recompute the measured-ceiling roofline fields for a new bw."""
    t_roof = max(r["bytes_per_iter"] / bw, r["flops_per_iter"] / r["peak_flops"])
    return {
        "roofline_fraction": t_roof * r["iters_per_sec"],
        "t_roofline_ms": t_roof * 1e3,
    }


class BandwidthTracker:
    """Interleaved probes of the card's deliverable memory rate and bf16
    product rate.

    ``sample()`` runs the memory probes (the read-probe kernel and
    ``torch.sum`` over X, a read+write stream, a GEMM against X) and the
    chained bf16 GEMM, and keeps each sample that is possible on the
    card.  The read probes are the binding ones for the roofline: the
    solver's traffic is dominated by its read of X.  :attr:`bw_ceiling` is
    the best memory sample of this run, capped at the nominal rate.
    """

    def __init__(self, mb: int = 128, gemm_shape=(8192, 8192, 128), mxu_dim: int = 4096,
                 device="cuda"):
        self.samples_stream: list[float] = []
        self.samples_gemm: list[float] = []
        self.samples_read: list[float] = []
        self.anomalies: list[float] = []  # discarded >nominal samples
        self.samples_mxu: list[float] = []
        self.anomalies_mxu: list[float] = []
        self._device = torch.device(device)
        self._build(mb, gemm_shape, mxu_dim)

    def _build(self, mb, gemm_shape, mxu_dim):
        dev = self._device
        self._mb = mb
        self._buf = torch.ones((mb * 1024 * 1024 // 4,), dtype=torch.float32, device=dev)
        m, n, k = gemm_shape
        self._gemm_shape = (m, n, k)
        self._x = torch.ones((m, n), dtype=torch.float32, device=dev)
        self._h = torch.ones((k, n), dtype=torch.float32, device=dev)
        # the read probe's s, its own in every trip, so no call can be elided
        self._s = torch.arange(110, dtype=torch.float32, device=dev)
        self._mxu_dim = mxu_dim
        self._mxu_a = torch.ones((mxu_dim, mxu_dim), dtype=torch.bfloat16, device=dev)
        # B = 1/d everywhere (exact for a power of two): each trip's product
        # is the last trip's output again, so the chain stays finite without
        # a scaling pass after the product
        self._mxu_b = torch.full((mxu_dim, mxu_dim), 1.0 / mxu_dim, dtype=torch.bfloat16,
                                 device=dev)

    def _read_probe(self, it):
        """STREAM-style read of X in the kernel language the solvers use:
        the read-probe kernel's column sums of X + s, s new each trip."""
        c = torch.zeros((), dtype=torch.float32, device=self._device)
        for t in range(it):
            c = c + read_probe(self._x, self._s[t])[0, 0]
        return float(c)

    def _read_sum(self, it):
        # bench.py's sum(maximum(x, t)) is one fused read of X under XLA; in
        # eager torch the maximum would write and re-read an m x n
        # temporary, three times the bytes counted as one.  torch.sum(x)
        # reads X once a call, and eager torch hoists nothing out of the
        # loop, so the comparand has no job to do here
        c = torch.zeros((), dtype=torch.float32, device=self._device)
        for _ in range(it):
            c = c + torch.sum(self._x)
        return float(c)

    def _stream(self, it):
        # read and write the buffer once a trip, in place: nothing is
        # allocated inside the timed loop
        for _ in range(it):
            self._buf.mul_(1.0000001)
        return float(self._buf[0])

    def _gemm(self, it):
        # read-dominated GEMM against X, at the solvers' full float32 products
        m, _, k = self._gemm_shape
        c = torch.zeros((m, k), dtype=torch.float32, device=self._device)
        with full_f32():
            for t in range(it):
                c = 0.5 * c + 0.5 * (self._x @ (self._h + t).T)
        return float(c[0, 0])

    def _mxu(self, it):
        # chained bf16 GEMM: each trip consumes the last trip's output, so
        # nothing can run ahead of it
        c = self._mxu_a
        for _ in range(it):
            c = torch.matmul(c, self._mxu_b)
        return float(c[0, 0])

    def _delta_time(self, fn, i1, i2):
        """Seconds per pass from the (i1 vs i2)-pass wall-time delta, which
        cancels the fixed cost of a call; every end point is a host read."""
        fn(i1)
        fn(i2)  # warm both

        def wall(it):
            t0 = time.perf_counter()
            fn(it)
            return time.perf_counter() - t0

        t1 = min(wall(i1), wall(i1))
        t2 = min(wall(i2), wall(i2))
        return max(t2 - t1, 1e-4) / (i2 - i1)

    def _keep(self, bucket, bw):
        """A sample above the card's nominal memory rate is not evidence of
        bandwidth but of a broken timing window, so it is DISCARDED, not
        capped: capping would turn an anomaly into a maximal measurement."""
        _, hbm_nominal = _chip_limits()
        if bw <= hbm_nominal:
            bucket.append(bw)
        else:
            self.anomalies.append(round(bw / 1e9, 1))

    def sample(self, iters=30):
        m, n, _ = self._gemm_shape
        with torch.no_grad():
            t = self._delta_time(self._read_probe, 10, 110)
            self._keep(self.samples_read, m * n * 4 / t)
            t = self._delta_time(self._read_sum, 5, 30)
            self._keep(self.samples_read, m * n * 4 / t)
            t = self._delta_time(self._stream, iters, 4 * iters)
            self._keep(self.samples_stream, 2 * self._mb * 1024 * 1024 / t)
            t = self._delta_time(self._gemm, 5, 30)
            self._keep(self.samples_gemm, m * n * 4 / t)
            t = self._delta_time(self._mxu, 5, 30)
        mxu = 2 * self._mxu_dim ** 3 / t
        peak_nominal, _ = _chip_limits()
        if mxu <= _MXU_SANITY * peak_nominal:
            self.samples_mxu.append(mxu)
        else:
            # the tensor cores cannot run 25% over their nominal clock: a
            # timing artifact, as the >nominal memory samples are
            self.anomalies_mxu.append(mxu)

    @property
    def bw_probe_best(self) -> float:
        """Best memory probe this run."""
        return max(self.samples_read + self.samples_stream + self.samples_gemm, default=0.0)

    @property
    def bw_ceiling(self) -> float:
        """Best memory probe this run, capped at the card's nominal rate
        (no probe can legitimately beat it)."""
        _, hbm_nominal = _chip_limits()
        return min(self.bw_probe_best, hbm_nominal)

    @property
    def mxu_ceiling(self) -> float:
        """Product ceiling for MFU claims: max(nominal bf16 peak, best sane
        chained-GEMM probe this run).  A sample above the nominal raises
        the ceiling (a larger denominator only lowers the claimed
        fraction), up to the _MXU_SANITY bound that sample() applies."""
        peak_nominal, _ = _chip_limits()
        return max([peak_nominal] + self.samples_mxu)

    def summary(self) -> dict:
        return {
            "mxu_samples_tflops": [round(s / 1e12, 1) for s in self.samples_mxu],
            "mxu_discarded_anomalies_tflops": [round(s / 1e12, 1) for s in self.anomalies_mxu],
            "read_samples": [round(s / 1e9, 1) for s in self.samples_read],
            "stream_rw_samples": [round(s / 1e9, 1) for s in self.samples_stream],
            "gemm_read_samples": [round(s / 1e9, 1) for s in self.samples_gemm],
            "best_this_run": round(self.bw_probe_best / 1e9, 1),
            "best_prior": 0.0,  # no probe record is kept between runs
            "used": round(self.bw_ceiling / 1e9, 1),
            "discarded_anomalies_gbps": self.anomalies,
        }


def _mur_problem(m, n, k, data_dtype, device, offset=0.0):
    """W0 (m, k), H0 (k, n) uniform (+ offset) and X = W0 H0 + 0.01 noise
    in ``data_dtype``, from seed 0; X's squared norm read to the host, so
    everything exists before any timing."""
    g = _generator(0, device)
    w0 = torch.rand((m, k), generator=g, device=device) + offset
    h0 = torch.rand((k, n), generator=g, device=device) + offset
    noise = torch.rand((m, n), generator=g, device=device)
    with full_f32():
        x = (w0 @ h0 + 0.01 * noise).to(data_dtype)
    del noise
    xsq = torch.sum(x.to(torch.float32) ** 2)
    float(xsq)
    return x, xsq, w0, h0


def _delta_rate(run, init, iters, long_iters):
    """(iterations/s, last long run's carry): ``run(carry, stop_i)`` from
    ``init()`` to ``iters`` and to ``long_iters``, each the better of two
    runs after one warm-up of 2, rated on the delta."""

    def timed(stop_i):
        carry = init()
        t0 = time.perf_counter()
        out = run(carry, stop_i)
        float(out.obj)  # the loop's host reads: the card is done
        return time.perf_counter() - t0, out

    float(run(init(), 2).obj)  # warm-up
    t1 = min(timed(iters)[0], timed(iters)[0])
    t2a, out = timed(long_iters)
    t2b, _ = timed(long_iters)
    t2 = min(t2a, t2b)
    assert int(out.i) == long_iters
    return (long_iters - iters) / max(t2 - t1, 1e-3), out


def bench_mur_eu(m=8192, n=8192, k=128, iters=50, data_dtype=torch.float32,
                 bw_measured=None, device="cuda"):
    device = torch.device(device)
    use_pallas = device.type == "cuda"
    with torch.no_grad():
        x, xsq, w0, h0 = _mur_problem(m, n, k, data_dtype, device)
        route, strips = mur_route(x, k, "eu", use_pallas)
        if route in ("high_rank", "plain"):
            x = x.to(torch.float32)  # as mur() does: the plain step's products take f32 X
        long_iters = 5 * iters

        def run(carry, stop_i):
            return _mur_block(
                x, xsq, carry, stop_i, 0.0, 0.0, 0.0, 0.0,
                distance_type="eu", min_iter=long_iters + 1, max_iter=long_iters + 1,
                objective="gram", route=route, strips=strips,
            )

        def init():
            return init_carry(torch.tensor(0.0), long_iters + 1, (w0, h0))

        iters_per_sec, out = _delta_rate(run, init, iters, long_iters)
    final_obj = float(out.obj)
    # GEMMs of the single-pass Gram-objective iteration:
    #   in the pass: X H^T (2mnk) + W Gh (2mk^2) + WtX (2mnk) + GramW (2mk^2)
    #   outside:     Gh = H H^T (2nk^2) + GramW H (2nk^2) + objective (2nk^2)
    # The 2-pass pair's extra m k^2 Gram is left out (an undercount).
    flops_per_iter = 4 * m * n * k + 4 * m * k * k + 6 * n * k * k
    # required traffic: X read once a pass, W read + written (2mk), H^T
    # read, WtX written and read, H written (4kn), factors f32;
    # temporaries excluded (fewer bytes: a lower, conservative fraction)
    xb = data_dtype.itemsize
    passes = 1 if route == "single" else 2
    bytes_per_iter = passes * m * n * xb + (2 * m * k + 4 * k * n) * 4
    peak_flops, hbm_nominal = _chip_limits()
    bw = bw_measured or hbm_nominal
    t_roof_meas = max(bytes_per_iter / bw, flops_per_iter / peak_flops)
    t_roof_nom = max(bytes_per_iter / hbm_nominal, flops_per_iter / peak_flops)
    return {
        "bytes_per_iter": bytes_per_iter,
        "flops_per_iter": flops_per_iter,
        "achieved_bw": bytes_per_iter * iters_per_sec,
        "iters_per_sec": iters_per_sec,
        "gflops_per_chip": flops_per_iter * iters_per_sec / 1e9,
        "roofline_fraction": t_roof_meas * iters_per_sec,
        "roofline_fraction_nominal": t_roof_nom * iters_per_sec,
        "t_iter_ms": 1e3 / iters_per_sec,
        "t_roofline_ms": t_roof_meas * 1e3,
        "final_obj": final_obj,
        "single_pass": route == "single",
        "m": m, "n": n, "k": k, "iters": iters,
        "device": _card_name() if device.type == "cuda" else device.type,
        "peak_flops": peak_flops,
        "hbm_nominal": hbm_nominal,
    }


def bench_mur_kl(m=8192, n=8192, k=128, iters=30, data_dtype=torch.bfloat16,
                 bw_measured=None, objective_every=1, device="cuda"):
    """KL MUR at headline scale with the lagged objective, with the same
    roofline accounting as EU.  At 8192 x 8192 r128 ``mur_route`` gives
    the 2-pass pair (the single pass's rule needs a narrower X): X is read
    twice an iteration (W pass, H pass; the lagged objective comes from
    the W pass and drops the third), and bytes_iter counts that."""
    device = torch.device(device)
    use_pallas = device.type == "cuda"
    with torch.no_grad():
        x, xsq, w0, h0 = _mur_problem(m, n, k, data_dtype, device, offset=0.1)
        route, strips = mur_route(x, k, "kl", use_pallas)
        if route in ("high_rank", "plain"):
            # the plain and high-rank steps take f32 X and carry the ratio
            # of the trailing pass (solvers/mur.py::mur)
            x = x.to(torch.float32)
            inner0 = (w0, h0, _passes(route)[0](x, w0, h0, eps=_EPS))
        else:
            inner0 = (w0, h0)
        long_iters = 5 * iters

        def run(carry, stop_i):
            return _mur_block(
                x, xsq, carry, stop_i, 0.0, 0.0, 0.0, 0.0,
                distance_type="kl", min_iter=long_iters + 1, max_iter=long_iters + 1,
                objective="lagged", route=route, strips=strips,
                objective_every=objective_every,
            )

        def init():
            return init_carry(torch.tensor(0.0), long_iters + 1, inner0)

        iters_per_sec, _ = _delta_rate(run, init, iters, long_iters)
    xb = data_dtype.itemsize
    passes = 2  # W pass + H pass (lagged objective: no third pass)
    # X twice, W r+w, H r+w (f32 factors); ratio tiles never materialized
    bytes_per_iter = passes * m * n * xb + (2 * m * k + 2 * k * n) * 4
    # each pass forms WH tiles (2mnk) and a numerator GEMM (2mnk)
    flops_per_iter = 8 * m * n * k
    peak_flops, hbm_nominal = _chip_limits()
    bw = bw_measured or hbm_nominal
    t_roof = max(bytes_per_iter / bw, flops_per_iter / peak_flops)
    return {
        "bytes_per_iter": bytes_per_iter,
        "flops_per_iter": flops_per_iter,
        "achieved_bw": bytes_per_iter * iters_per_sec,
        "iters_per_sec": iters_per_sec,
        "gflops_per_chip": flops_per_iter * iters_per_sec / 1e9,
        "roofline_fraction": t_roof * iters_per_sec,
        "peak_flops": peak_flops,
        "m": m, "n": n, "k": k,
    }


def bench_serving(b=64, r=128, n=1 << 20, topk=100, iters=20, device="cuda") -> dict:
    """Serving throughput: QPS of a b-user batch retrieving the top-k of n
    rank-r item columns, float32 exact against bf16 retrieve-then-rerank
    (a pre-stored bf16 H), and the quantized stage's recall against the
    exact answer.  Delta-timed; each trip scales the batch by
    (1 + t 1e-6), so no trip repeats another."""
    device = torch.device(device)
    g = _generator(7, device)
    w = torch.rand((b, r), generator=g, device=device)
    h = torch.rand((r, n), generator=g, device=device)
    hq = h.to(torch.bfloat16)

    def run_exact(it):
        c = torch.zeros((), device=device)
        for t in range(it):
            v, _ = topk_scores_dense(w * (1.0 + t * 1e-6), h, topk)
            c = c + v[0, 0]
        return float(c)

    def run_quant(it):
        c = torch.zeros((), device=device)
        for t in range(it):
            v, _ = _quantized_rerank(w * (1.0 + t * 1e-6), h, topk, "bf16", 2, hq=hq)
            c = c + v[0, 0]
        return float(c)

    def delta(fn):
        fn(2)
        fn(iters)
        fn(5 * iters)

        def wall(it):
            t0 = time.perf_counter()
            fn(it)
            return time.perf_counter() - t0

        t1 = min(wall(iters), wall(iters))
        t2 = min(wall(5 * iters), wall(5 * iters))
        return max(t2 - t1, 1e-4) / (4 * iters)

    with torch.no_grad():
        t_exact = delta(run_exact)
        t_quant = delta(run_quant)
        _, i_e = topk_scores_dense(w, h, topk)
        _, i_q = _quantized_rerank(w, h, topk, "bf16", 2, hq=hq)
    rec = float(recall_at_k(i_q, i_e))
    h_bytes = r * n * 4
    return {
        "items": n, "rank": r, "batch": b, "topk": topk,
        "qps_exact_f32": round(b / t_exact, 1),
        "qps_quantized_bf16": round(b / t_quant, 1),
        "batch_latency_ms_exact": round(t_exact * 1e3, 3),
        "batch_latency_ms_quantized": round(t_quant * 1e3, 3),
        "recall_at_100_quantized_vs_exact": rec,
        "scoring_bw_gbps_exact": round(h_bytes / t_exact / 1e9, 1),
        "scoring_bw_gbps_quantized": round(h_bytes / 2 / t_quant / 1e9, 1),
    }


def bench_solver_rates(m=2048, n=1024, k=64, iters=8, device="cuda", deltas=None) -> dict:
    """Warm iterations/s of eight solver families on one problem, each
    from the same numpy inits: after one warm-up run, each family runs
    ``iters`` and ``iters + deltas[family]`` iterations and is rated on
    the delta (the median of three pairs, each point the better of two
    runs, a 50 ms floor on the delta).  ``deltas`` defaults to
    RATE_DELTAS, bench.py's.  Each family's seconds go to stderr."""
    from .solvers import admm, anls, ao_admm, hals, mur, mur_masked

    deltas = RATE_DELTAS if deltas is None else deltas
    device = torch.device(device)
    g = _generator(1, device)
    w0 = torch.rand((m, k), generator=g, device=device)
    h0 = torch.rand((k, n), generator=g, device=device)
    with full_f32():
        x = w0 @ h0 + 0.05
    w0n, h0n = w0.cpu().numpy(), h0.cpu().numpy()
    mask = (torch.rand((m, n), generator=_generator(2, device), device=device) < 0.25
            ).to(torch.float32)

    def run_timed(fn, n_it, **kw):
        common = dict(w_init=w0n, h_init=h0n, min_iter=n_it, max_iter=n_it,
                      tol1=0.0, tol2=0.0)
        t0 = time.perf_counter()
        res = fn(x, k, **common, **kw)  # W and H come back to the host
        dt = time.perf_counter() - t0
        assert len(res.obj_history) >= n_it
        return dt

    def rate(fn, delta, **kw):
        # one warm-up run: bench.py's second one, at the long count,
        # compiles that count's program, and the port's host loops compile
        # nothing per count
        run_timed(fn, iters, **kw)

        def one_rate():
            t1 = min(run_timed(fn, iters, **kw), run_timed(fn, iters, **kw))
            t2 = min(run_timed(fn, iters + delta, **kw), run_timed(fn, iters + delta, **kw))
            return delta / max(t2 - t1, 0.05)  # 50 ms measurement floor

        # median of three pairs: it discards one outlier either way
        rates = sorted(one_rate() for _ in range(3))
        return round(rates[1], 2)

    def masked_eu(data, kk, **kw):
        return mur_masked(data, mask, kk, **kw)

    families = (("mur_kl", mur, dict(distance_type="kl")),
                ("mur_eu", mur, dict(distance_type="eu")),
                ("mur_masked_eu", masked_eu, dict(distance_type="eu")),
                ("hals", hals, {}),
                ("anls", anls, {}),
                ("admm", admm, {}),
                ("ao_admm", ao_admm, {}),
                ("ao_admm_local_l1inf", ao_admm, dict(rho_mode="adaptive",
                                                      reg_w=(0.1, "l1inf"))))
    out = {}
    for name, fn, kw in families:
        t0 = time.perf_counter()
        out[name] = rate(fn, deltas[name], **kw)
        print(f"bench: solver rate {name} {out[name]} it/s in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


def _timed(label, fn):
    """fn()'s result; its seconds go to stderr."""
    t0 = time.perf_counter()
    out = fn()
    print(f"bench: {label} in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


def _recorded(label, fn):
    """:func:`_timed`, with {"error": ...} in the result's place when fn
    raises (the traceback goes to stderr)."""
    try:
        return _timed(label, fn)
    except Exception as e:
        traceback.print_exc()
        return {"error": str(e)[:200]}


def errors(line, path=()) -> list:
    """The paths of every "error" field in a bench line."""
    if not isinstance(line, dict):
        return []
    found = [".".join(path + ("error",))] if "error" in line else []
    for key, value in line.items():
        found += errors(value, path + (key,))
    return found


def main(deltas=None) -> dict:
    """Run the bench on the card, print its line and return it; raise
    after printing if a sub-bench recorded an error.  ``deltas``: the
    solver rates' extra iterations (default RATE_DELTAS); other deltas
    are named in the line's ``extra.solver_rate_deltas``."""
    _chip_limits()  # an H100, or raise: the bench never runs on the CPU
    t0 = time.perf_counter()
    # interleave the probes across the bench window, so that one slow
    # patch cannot set the ceiling
    tracker = BandwidthTracker()
    _timed("probes", tracker.sample)
    r16 = _timed("MUR EU bf16 X", lambda: bench_mur_eu(data_dtype=torch.bfloat16))
    tracker.sample()
    r = _timed("MUR EU f32 X", bench_mur_eu)

    def best_of_three_r512():
        # compute-bound mode: rank 512, best of three (the MFU claim is a
        # capability statement; the denominator is the best probe sample)
        best = bench_mur_eu(m=8192, n=2048, k=512, iters=50, data_dtype=torch.bfloat16)
        for _ in range(2):
            again = bench_mur_eu(m=8192, n=2048, k=512, iters=50, data_dtype=torch.bfloat16)
            if again["iters_per_sec"] > best["iters_per_sec"]:
                best = again
        return best

    r512 = _recorded("MUR EU r512", best_of_three_r512)
    tracker.sample()
    rkl = _recorded("MUR KL", lambda: bench_mur_kl(data_dtype=torch.bfloat16,
                                                   bw_measured=tracker.bw_ceiling))
    rkl8 = _recorded("MUR KL objective_every=8",
                     lambda: bench_mur_kl(data_dtype=torch.bfloat16,
                                          bw_measured=tracker.bw_ceiling, objective_every=8))
    serving = _recorded("serving r128", bench_serving)
    serving_r512 = _recorded("serving r512", lambda: bench_serving(b=64, r=512, n=1 << 19,
                                                                   topk=100, iters=10))
    tracker.sample()
    rates = _recorded("solver rates", lambda: bench_solver_rates(deltas=deltas))
    tracker.sample()

    # every probe sample is in before any headline math: every field
    # below reflects the same final ceiling
    bw_ceiling = tracker.bw_ceiling
    r = {**r, **_refraction(r, bw_ceiling)}
    r16 = {**r16, **_refraction(r16, bw_ceiling)}
    if "error" not in rkl:
        rkl = {**rkl, **_refraction(rkl, bw_ceiling)}
        kl_extra = {
            "iters_per_sec": round(rkl["iters_per_sec"], 2),
            "gflops_per_chip": round(rkl["gflops_per_chip"], 1),
            "roofline_fraction_measured_bw": round(rkl["roofline_fraction"], 3),
            "achieved_read_bw_gbps": round(rkl["achieved_bw"] / 1e9, 1),
            "shape": [rkl["m"], rkl["n"], rkl["k"]],
            "note": "MUR KL with the lagged objective on the route mur_route picks "
                    "(the 2-pass pair at this shape; the single pass's rule needs a "
                    "narrower X); bytes = X twice + factor r/w. The fraction is "
                    "against that 2-pass design.",
        }
        if "error" not in rkl8:
            kl_extra["iters_per_sec_objective_every8"] = round(rkl8["iters_per_sec"], 2)
        else:
            kl_extra["iters_per_sec_objective_every8"] = rkl8
    else:
        kl_extra = rkl
    mxu_ceiling = tracker.mxu_ceiling
    if "error" not in r512:
        mfu = r512["flops_per_iter"] * r512["iters_per_sec"] / mxu_ceiling
        r512_extra = {
            "iters_per_sec": round(r512["iters_per_sec"], 2),
            "tflops_per_chip": round(r512["gflops_per_chip"] / 1e3, 1),
            "mfu_vs_measured_mxu": round(mfu, 3),
            "mxu_ceiling_tflops": round(mxu_ceiling / 1e12, 1),
            "meets_70pct_mxu_target": bool(mfu >= 0.70),
            "shape": [r512["m"], r512["n"], r512["k"]],
            "single_pass_kernel": r512["single_pass"],
            "note": "BASELINE's >=70%-of-peak target asked of the production solver "
                    "at rank 512 (bf16 X). MFU denominator = max(the card's nominal "
                    "bf16 peak, best chained 4096^2 bf16 GEMM probe this run): the "
                    "conservative direction for a fraction claim.",
        }
    else:
        r512_extra = r512

    # the ceiling is never the solver itself: if the solver moved bytes
    # faster than any probe, the probes understate the deliverable rate,
    # and the headline falls back to the nominal-rate fraction
    achieved = max(r["achieved_bw"], r16["achieved_bw"])
    undershoot = achieved > bw_ceiling
    if undershoot:
        headline_fraction = r16["roofline_fraction_nominal"]
        ceiling_source = "nominal spec (probes undershot the solver)"
    else:
        headline_fraction = r16["roofline_fraction"]
        ceiling_source = "measured probe (read-probe kernel / torch best-of)"
    probe = tracker.summary()
    line = {
        "metric": "mur_eu_rank128_bf16x_gflops_per_chip",
        "value": round(r16["gflops_per_chip"], 1),
        "unit": "GFLOP/s",
        "vs_baseline": round(headline_fraction / _TARGET, 3),
        "extra": {
            "iters_per_sec": round(r16["iters_per_sec"], 2),
            "t_iter_ms": round(r16["t_iter_ms"], 4),
            "t_roofline_ms": round(r16["t_roofline_ms"], 4),
            "roofline_fraction_measured_bw": round(r16["roofline_fraction"], 3),
            "roofline_fraction_nominal_bw": round(r16["roofline_fraction_nominal"], 3),
            "probes_undershoot_solver": undershoot,
            "bw_probe_gbps": {
                **probe,
                "ceiling_source": ceiling_source,
                "nominal": round(r16["hbm_nominal"] / 1e9, 1),
            },
            "shape": [r16["m"], r16["n"], r16["k"]],
            "single_pass_kernel": r16["single_pass"],
            "rank512_compute_bound": r512_extra,
            "kl_headline": kl_extra,
            "serving_topk": serving,
            "serving_topk_r512": serving_r512,
            "f32_data_mode": {
                "iters_per_sec": round(r["iters_per_sec"], 2),
                "gflops_per_chip": round(r["gflops_per_chip"], 1),
                "roofline_fraction_measured_bw": round(r["roofline_fraction"], 3),
                "roofline_fraction_nominal_bw": round(r["roofline_fraction_nominal"], 3),
            },
            "solver_rates_it_per_s": rates,
            # only where they are not bench.py's, so its report keeps its keys
            **({"solver_rate_deltas": dict(deltas)}
               if deltas is not None and deltas != RATE_DELTAS else {}),
            "device": r16["device"],
            "note": "Headline = bf16-X MUR EU iteration through the port's solver loop "
                    "(Gram objective, one host read an iteration) on the route "
                    "mur_route picks (the single pass at 8192^2 r128); bf16-bytes "
                    "roofline accounting. vs_baseline = fraction-of-roofline / 0.70; "
                    "the ceiling is the best interleaved solver-independent probe of "
                    "this run (read-probe kernel / torch.sum / in-place stream / f32 "
                    "GEMM, delta-timed, >nominal samples discarded, nothing kept "
                    "between runs), never the solver itself. Memory-bound at rank "
                    "128: bytes = X once + factor r/w only.",
        },
    }
    print(json.dumps(line), flush=True)
    print(f"bench: all in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    failed = errors(line)
    if failed:
        raise RuntimeError(f"bench: sub-benches failed: {', '.join(failed)}")
    return line


if __name__ == "__main__":
    main()
