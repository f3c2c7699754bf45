"""Structured event tracing and per-iteration metric timelines for the
serving stack (trace export comes with a later slice of the port)."""

from .tracer import Event, Tracer, merge_events
from .metrics import Histogram, MetricsRegistry, percentile

__all__ = [
    "Event",
    "Tracer",
    "merge_events",
    "Histogram",
    "MetricsRegistry",
    "percentile",
]
