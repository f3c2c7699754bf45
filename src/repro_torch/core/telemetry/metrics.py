"""Per-iteration metrics registry and shared percentile helper.

The registry is the numeric companion to the event tracer: where the
tracer answers *why* (which request triggered the preemption), the metrics
timeline answers *how much over time* (KV utilization, backlog tokens,
budget fill, hit rates) — one row per engine ``step()``, exportable as CSV
or JSON for plotting.

``percentile`` is also the single home for the nearest-rank percentile
used by ``ServiceStats`` and ``SimResult`` (previously hand-rolled in
both, with undefined behavior on empty input).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile with defined small-n behavior.

    Returns ``sorted(values)[min(n - 1, int(q / 100 * n))]`` — the same
    clamped-index convention the serving stats always used — and ``inf``
    for empty input (a percentile over nothing is an unmet SLO, not a
    crash). ``q`` outside [0, 100] is clamped; indices never go negative.
    """
    n = len(values)
    if n == 0:
        return math.inf
    q = min(100.0, max(0.0, q))
    idx = min(n - 1, int(q / 100.0 * n))
    return sorted(values)[idx]


class Histogram:
    """A value reservoir summarized by count/sum/min/max and nearest-rank
    percentiles. Unbounded on purpose — per-run observation counts here
    are request-scale (thousands), not token-scale."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(v)

    def summary(self) -> Dict[str, float]:
        vs = self.values
        if not vs:
            return {"count": 0}
        return {
            "count": len(vs),
            "sum": sum(vs),
            "min": min(vs),
            "max": max(vs),
            "p50": percentile(vs, 50),
            "p90": percentile(vs, 90),
            "p99": percentile(vs, 99),
        }


class MetricsRegistry:
    """Counters (cumulative), gauges (last value), histograms (reservoir),
    snapshotted into a timeline row per iteration.

    Like the tracer, the registry is held as ``None`` when telemetry is
    off — callers guard with one attribute test, so the disabled path
    allocates nothing.
    """

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.timeline: List[Dict[str, float]] = []

    def count(self, name: str, delta: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.observe(value)

    def snapshot(self, ts: float, iteration: int) -> Dict[str, float]:
        """Append one timeline row: current gauges + cumulative counters."""
        row: Dict[str, float] = {"ts": ts, "iteration": iteration}
        row.update(self.gauges)
        row.update(self.counters)
        self.timeline.append(row)
        return row

    def rows(self) -> List[Dict[str, float]]:
        return self.timeline

    def summaries(self) -> Dict[str, Dict[str, float]]:
        return {name: h.summary() for name, h in self.histograms.items()}
