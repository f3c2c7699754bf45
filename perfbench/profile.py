"""The device trace of a traced run, reduced to what the per-layer metrics
read.

:func:`extract` takes a finished ``torch.profiler.profile`` apart into
plain tuples (times in seconds on the profiler's clock): the device's
operations, the benchmark's ``pb.*`` spans on the host with the device
time of the kernels launched inside each, and the ``pb.window`` span that
bounds the profiled stretch. :class:`Trace` reduces those tuples; it is
tested on the CPU with made-up tuples.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.metrics import _yardstick as Y

WINDOW = "pb.window"
# spans whose device time the breakdown lists beside the kernels: the
# layers, not the engine's calls that contain them
LAYER_SPANS = ("pb.moe_forward", "pb.paged_attention",
               "pb.prefill_attention_paged", "pb.blockwise_attention",
               "pb.attention_partial", "pb.merge_partials_tree", "pb.sample")


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "pb."))


@dataclasses.dataclass
class Trace:
    """``ops``: (name, start, end, launch) of each device operation, with
    the host time of the runtime call that launched it (None where the
    trace links none); ``spans``: (name, start, end) of each ``pb.*``
    span on the host."""

    ops: List[Tuple[str, float, float, Optional[float]]]
    spans: List[Tuple[str, float, float]]
    lo: float  # the profiled stretch
    hi: float
    iterations: int  # engine iterations inside it

    def __post_init__(self):
        self._span_s = self._attribute()

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return Y.union_s(((s, e) for _, s, e, _ in self.ops), self.lo,
                         self.hi)

    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0 or not self.ops:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def launches(self) -> int:
        return sum(1 for n, s, _, _ in self.ops
                   if _is_kernel(n) and self.lo <= s < self.hi)

    def _sweep(self, points):
        """Walk span starts and ends and ``points`` ((time, payload)) in
        time order; yield (payload, the spans open at that time, innermost
        last). The host thread's spans nest."""
        events = []
        for i, (n, s, e) in enumerate(self.spans):
            if n != WINDOW:
                events.append((s, 1, i))
                events.append((e, 0, i))
        for j, (t, _) in enumerate(points):
            events.append((t, 2, j))
        events.sort(key=lambda x: (x[0], x[1]))
        open_ = []
        for _, kind, i in events:
            if kind == 1:
                open_.append(i)
            elif kind == 0:
                if i in open_:
                    open_.remove(i)
            else:
                yield points[i][1], open_

    def _attribute(self) -> Dict[str, Tuple[float, int]]:
        """Device seconds of each span name: per span, the union of the
        operations launched while it was open on the host, summed over
        the spans of that name; and the spans' count."""
        per_span = defaultdict(list)
        points = [(t, (s, e)) for _, s, e, t in self.ops if t is not None]
        for iv, open_ in self._sweep(points):
            for i in open_:
                per_span[i].append(iv)
        out = {}
        for i, (n, _, _) in enumerate(self.spans):
            secs = Y.union_s(per_span.get(i, ()), -float("inf"),
                             float("inf"))
            t, c = out.get(n, (0.0, 0))
            out[n] = (t + secs, c + 1)
        return out

    def span_device_s(self, name: str) -> Tuple[float, int]:
        """Device seconds of the operations launched inside every ``name``
        span, and the number of those spans."""
        return self._span_s.get(name, (0.0, 0))

    def top_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(float)
        for n, s, e, _ in self.ops:
            by["kernel:" + n[:100]] += e - s
        for n in LAYER_SPANS:
            t, calls = self.span_device_s(n)
            if t > 0:
                by["span:" + n[3:]] += t
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])
                [:k]]

    def gaps_by_span(self, k: int = 10) -> List[list]:
        """Idle stretches of the device, summed by the innermost ``pb.*``
        span that was open on the host when each began."""
        gaps = Y.idle_gaps(((s, e) for _, s, e, _ in self.ops), self.lo,
                           self.hi)
        by = defaultdict(float)
        for (g0, g1), open_ in self._sweep([(g0, (g0, g1))
                                            for g0, g1 in gaps]):
            name = self.spans[open_[-1]][0][3:] if open_ else "no span"
            by[name] += g1 - g0
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])
                [:k]]


def extract(prof, iterations: int) -> Optional[Trace]:
    """The tuples of a finished profiler, or None where it has no
    ``pb.window`` span. A device operation and the runtime call that
    launched it (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...) share a
    correlation id, the events' ``id``."""
    from torch.autograd import DeviceType

    dev, launch, spans, window = [], {}, [], None
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == DeviceType.CPU:
            if ev.name.startswith("pb."):
                spans.append((ev.name, s, e))
                if ev.name == WINDOW:
                    window = (s, e)
            elif ev.name.startswith("cu"):
                launch[ev.id] = s
        elif not ev.name.startswith("pb."):
            dev.append((ev.name, s, e, ev.id))
    if window is None:
        return None
    ops = [(n, s, e, launch.get(i)) for n, s, e, i in dev]
    return Trace(ops, spans, window[0], window[1], iterations)


def result_fields(trace: Trace) -> Tuple[Dict[str, float], dict]:
    """``busy_s`` and ``window_s`` for the result's ``device``, and its
    ``breakdown``."""
    return ({"busy_s": trace.busy_s, "window_s": trace.window_s},
            {"device_ops": trace.top_ops(), "idle_gaps": trace.gaps_by_span()})
