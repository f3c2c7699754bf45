"""The program's own spans, placed on the device trace's clock.

While a ``torch.profiler`` session is on, the port's engine records the
phases of each step (``repro_torch.core.telemetry``: nested complete spans
of the ``engine`` category, ``req`` instants), stamped in seconds of the
Unix epoch, the clock the profiler stamps host events with, and keeps the
tracer reachable after the engine is freed (``last_profiled``). This
module reads the newest such tracer without emptying it, places its spans
on the profiled stretch's clock and splits the device's idle time among
them. A program that records no such spans gives None here, and so does
every reader that uses this module.

**The anchor.** The program's ``iteration`` spans, in order, against the
benchmark's ``pb.engine.step`` spans of the stretch, each of which wraps
one: the median of their start differences maps the program's times onto
the trace's seconds. Where the program kept more iterations than the
stretch holds, the consecutive run of them whose differences spread least
is taken. The residuals (each difference less the median) say how well
the two clocks agree.

**The idle split.** Each idle gap of the device (no operation running,
:func:`_yardstick.idle_gaps`) is cut at the program's span boundaries, and
each part goes to the innermost span open during it, or to no span.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.metrics import _yardstick as Y

STEP = "pb.engine.step"
LAUNCH = ("decode.layers", "chunk.layers")  # the host launching the layers
WAIT = "sample.wait"  # the host waiting for the device's sampled tokens


@dataclasses.dataclass
class Program:
    """``spans``: (name, start, end, span id) of each ``engine`` span on the
    trace's clock; ``instants``: (name, request id, time) of each ``req``
    instant; ``residuals``: the anchor's, in seconds."""

    spans: List[Tuple[str, float, float, int]]
    instants: List[Tuple[str, Optional[int], float]]
    residuals: List[float]


def kept_events() -> Optional[list]:
    """The events of the newest tracer the program kept from a profiler
    session, or None where it kept none (or keeps none at all)."""
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    kept = getattr(telemetry, "last_profiled", lambda: None)()
    return kept.events() if kept is not None else None


def anchor(iters: List[Tuple[float, float]],
           steps: List[Tuple[float, float]]
           ) -> Optional[Tuple[float, List[float]]]:
    """(offset, residuals) mapping the program's times onto the trace's:
    ``iters`` and ``steps`` are (start, end) of the program's iteration
    spans and of the stretch's step spans, each in time order. None where
    the program has fewer iterations than the stretch has steps."""
    n = len(steps)
    if n == 0 or len(iters) < n:
        return None
    best = None
    for k in range(len(iters) - n + 1):
        d = [s[0] - p[0] for p, s in zip(iters[k:k + n], steps)]
        med = statistics.median(d)
        res = [x - med for x in d]
        spread = max(map(abs, res))
        if best is None or spread < best[0]:
            best = (spread, med, res)
    return best[1], best[2]


def place(events, trace) -> Optional[Program]:
    """The program's ``events`` (telemetry ``Event``s) on the clock of
    ``trace`` (:class:`perfbench.profile.Trace`), or None where they do
    not match its steps."""
    iters = sorted((e.ts, e.ts + e.dur) for e in events
                   if e.ph == "X" and e.name == "iteration")
    steps = sorted((s, e) for n, s, e in trace.spans if n == STEP)
    fit = anchor(iters, steps)
    if fit is None:
        return None
    off, residuals = fit
    spans = [(e.name, e.ts + off, e.ts + e.dur + off, e.args["span"])
             for e in events if e.ph == "X" and e.cat == "engine"]
    instants = [(e.name, e.rid, e.ts + off) for e in events
                if e.ph == "i" and e.cat == "req"]
    return Program(sorted(spans, key=lambda s: s[1]), instants, residuals)


def program(run) -> Optional[Program]:
    """The program's spans of a traced run, or None."""
    if run.trace is None:
        return None
    events = kept_events()
    return None if not events else place(events, run.trace)


def innermost(spans) -> List[Tuple[float, float, str]]:
    """The stretches in which some span is open, in time order, each with
    the name of the innermost one (the spans nest: one thread records
    them, and a span's id is larger than its parent's)."""
    bounds = []
    for name, s, e, sid in spans:
        bounds.append((s, 1, sid, name))
        bounds.append((e, 0, -sid, name))
    # at one time: ends before starts, inner ends first, outer starts first
    bounds.sort()
    out, open_, prev = [], [], None
    for t, starts, key, name in bounds:
        if open_ and t > prev:
            out.append((prev, t, open_[-1][1]))
        if starts:
            open_.append((key, name))
        else:
            open_.remove((-key, name))
        prev = t
    return out


def idle_by_span(prog: Program, trace) -> Dict[Optional[str], float]:
    """Seconds of the device's idle gaps in the stretch by the innermost
    program span open during each part of them (None: no span open)."""
    gaps = Y.idle_gaps(((s, e) for _, s, e, _ in trace.ops), trace.lo,
                       trace.hi)
    segs = innermost(prog.spans)
    out: Dict[Optional[str], float] = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        t, k = g0, j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, name = segs[k]
            if s0 > t:
                out[None] += s0 - t
            hi = min(s1, g1)
            out[name] += hi - max(s0, t)
            t = hi
            k += 1
        if g1 > t:
            out[None] += g1 - t
    return dict(out)


def span_s(prog: Program, name: str, lo: float, hi: float) -> float:
    """Seconds of the ``name`` spans inside ``[lo, hi]``."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for n, s, e, _ in prog.spans if n == name)


def idle_split(run) -> Optional[Tuple[float, float, float]]:
    """(launch, host, wait) idle seconds of a traced run's stretch: inside
    the layers' spans, inside ``sample.wait``, and everywhere else (other
    spans, or none). None without device operations or program spans."""
    tr = run.trace
    if tr is None or not tr.ops or not tr.iterations:
        return None
    prog = program(run)
    if prog is None:
        return None
    idle = idle_by_span(prog, tr)
    launch = sum(idle.get(n, 0.0) for n in LAUNCH)
    wait = idle.get(WAIT, 0.0)
    return launch, sum(idle.values()) - launch - wait, wait


def checks(run) -> Optional[dict]:
    """How far the placement and the split can be trusted in a traced run:
    the anchor's residuals (p90 of their size, us), the device's idle share
    inside ``sample.wait`` (%), and how far launch + host + wait idle falls
    from the stretch's idle (% of the stretch); with the idle by span."""
    prog = program(run)
    split = idle_split(run)
    if prog is None or split is None:
        return None
    tr = run.trace
    idle = idle_by_span(prog, tr)
    wait_s = span_s(prog, WAIT, tr.lo, tr.hi)
    return {
        "residual_p90_us": 1e6 * Y.percentile(
            [abs(r) for r in prog.residuals], 90),
        "steps_matched": len(prog.residuals),
        "wait_idle_pct": 100.0 * split[2] / wait_s if wait_s else None,
        "split_error_pct": 100.0 * abs(
            sum(split) - (tr.window_s - tr.busy_s)) / tr.window_s,
        "idle_by_span_s": {str(k): v for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])},
    }
