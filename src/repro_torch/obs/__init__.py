"""Span tracing and convergence telemetry for the port's engines."""
from repro_torch.obs.telemetry import (
    ConvergenceTrace,
    trace_from_block_activity,
    trace_from_col_rounds,
)
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer, tspan

__all__ = [
    "ConvergenceTrace",
    "trace_from_block_activity",
    "trace_from_col_rounds",
    "NULL_SPAN",
    "Span",
    "Tracer",
    "tspan",
]
