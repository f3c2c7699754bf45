"""Unified telemetry: structured event tracing, per-iteration metric
timelines, and Chrome/Perfetto trace export for the serving stack."""

from .tracer import Event, Tracer, merge_events
from .metrics import Histogram, MetricsRegistry, percentile
from .export import (
    export_chrome_trace,
    export_metrics_csv,
    export_metrics_json,
    to_chrome_trace,
    validate_swap_balance,
    validate_trace_events,
)

__all__ = [
    "Event",
    "Tracer",
    "merge_events",
    "Histogram",
    "MetricsRegistry",
    "percentile",
    "export_chrome_trace",
    "export_metrics_csv",
    "export_metrics_json",
    "to_chrome_trace",
    "validate_swap_balance",
    "validate_trace_events",
]
