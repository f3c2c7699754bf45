"""Unified telemetry: structured event tracing, per-iteration metric
timelines, and Chrome/Perfetto trace export for the serving stack."""

from .tracer import (Event, Tracer, keep_profiled, last_profiled,
                     merge_events, profiler_clock)
from .metrics import MetricsRegistry, percentile
from .export import (
    export_chrome_trace,
    export_metrics_csv,
    to_chrome_trace,
    validate_swap_balance,
    validate_trace_events,
)

__all__ = [
    "Event",
    "Tracer",
    "keep_profiled",
    "last_profiled",
    "merge_events",
    "profiler_clock",
    "MetricsRegistry",
    "percentile",
    "export_chrome_trace",
    "export_metrics_csv",
    "to_chrome_trace",
    "validate_swap_balance",
    "validate_trace_events",
]
