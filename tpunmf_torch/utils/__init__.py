from .metrics import MetricsLogger, objective_trace_stream
from .profiling import (
    debug_nans,
    determinism_check,
    enable_compilation_cache,
    named_scope,
    trace,
)

__all__ = [
    "MetricsLogger",
    "objective_trace_stream",
    "trace",
    "named_scope",
    "debug_nans",
    "determinism_check",
    "enable_compilation_cache",
]
