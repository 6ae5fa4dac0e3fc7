"""Metric readers, one file each, found by the metric's name in
BENCHMARK.json: ``read(ctx)`` gives a number, or None where the run holds
nothing to read.  End-to-end readers get the window's context (setup_s,
window_s, iterations, fits, fit_s), per-layer readers the traced run's."""
