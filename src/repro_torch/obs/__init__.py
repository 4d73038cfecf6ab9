"""Span tracing, the metrics registry and convergence telemetry for the
port's engines and server."""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bounded_append,
    percentile,
)
from repro_torch.obs.telemetry import (
    ConvergenceTrace,
    trace_from_block_activity,
    trace_from_col_rounds,
)
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer, child, self_times, tspan

__all__ = [
    "ConvergenceTrace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "bounded_append",
    "percentile",
    "trace_from_block_activity",
    "trace_from_col_rounds",
    "NULL_SPAN",
    "Span",
    "Tracer",
    "child",
    "self_times",
    "tspan",
]
