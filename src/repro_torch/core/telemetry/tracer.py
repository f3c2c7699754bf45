"""Low-overhead structured event tracer for the serving stack.

The stack makes dozens of consequential decisions per iteration — chunk
composition, preemption victim choice, placement, borrow-vs-copy, board
eviction — and post-hoc aggregates (``ServiceStats``) cannot explain a P99
stall or a preemption storm. The :class:`Tracer` records those decisions as
**typed events in a ring buffer**, cheap enough to leave on in the
virtual-clock simulator and exportable to Chrome/Perfetto trace-event JSON
(``repro_torch.core.telemetry.export``).

Design constraints:

* **No cost when off.** Tracing is opt-in per backend; when disabled the
  backend holds ``trace = None`` and every emission site is guarded with a
  single attribute test — no event object, argument dict, or string is ever
  constructed. ``tests/test_torch_engine_spans.py`` asserts this for the
  engine (zero allocations attributed to this package over its steps).
* **Bounded memory.** Events land in a fixed-capacity ring; once full the
  oldest events are overwritten (``dropped`` counts them). Exporters see
  events in emission order.
* **One clock per owner.** Every event is stamped through the owner's
  clock when it happens: a virtual-clock backend passes its ``clock``
  callable (sim traces are perfectly reproducible — no wall time
  anywhere); a wall-clock owner takes the default, :func:`profiler_clock`,
  the clock ``torch.profiler`` stamps its host events with, so an engine's
  spans lie on the same time line as a profile's device operations. A
  cluster router merges per-child tracers onto one timeline by sorting on
  these timestamps.
* **Reachable after a profile.** A tracer that recorded while a
  ``torch.profiler`` session was on is handed to :func:`keep_profiled`;
  :func:`last_profiled` returns the newest of them, not emptied, after its
  owner is gone (a benchmark reads the spans once its engine is freed).
  One is kept, until a newer one replaces it, for the life of the
  process.

Event vocabulary (``cat``/``name``; ``args`` carry cause attribution):

====================  =====================================================
``request``           per-request async span: ``begin`` at submission /
                      fork, ``end`` at finish or drop (``reason=...``)
``req``               lifecycle instants inside the span: ``chunk`` (one
                      planned prefill chunk: start/length/last),
                      ``chunk_rescind`` / ``decode_rescind`` (planned work
                      withdrawn from a preemption victim), ``first_token``
``sched``             scheduler decisions with *why*: ``admit`` (cached /
                      leased tokens, first chunk), ``refuse`` (``why`` in
                      budget_sliver | no_pages | solo_wait | swap_wait |
                      swap_hold), ``preempt`` (victim + ``trigger``
                      request + ``kind`` victim|self), ``cow_rescind``,
                      ``swap_out`` / ``swap_in`` (host-tier page moves;
                      a speculative swap-out's instant fires when the
                      transfer COMPLETES, ``kind=speculative``),
                      ``swap_issue`` / ``swap_cancel`` (overlapped
                      swap-out issued early / rescinded)
``swap``              overlapped-transfer async span: ``pending`` begun
                      at issue and ended at resolution with ``outcome``
                      complete | cancel | orphaned — the device pages are
                      DMA-in-flight for the whole span and the request
                      does no work inside it (``validate_swap_balance``)
``lease``             zero-copy lease lifecycle: ``lend`` / ``borrow``
                      (rManager sides), ``acquire`` / ``release``
                      (scheduler holds), ``repay`` (creditor settled)
``board``             publication board: ``publish`` / ``lookup`` /
                      ``evict``
``net``               modeled network charges: ``charge`` (seconds),
                      ``copy`` / ``lease`` RPCs, ``promote`` (leased
                      prefix materialized locally) (router)
``router``            ``place``: placement decision + policy
``handoff``           disaggregated prefill->decode KV move: async ``kv``
                      span per request, begun at the prefill host's clock
                      (``src``/``dst``/``mode``/``pages``) and ended at
                      the decode host's once the transfer is charged
``engine``            nested complete spans of a wall-clock engine's step
                      (one track per instance), each with ``span`` and
                      ``parent`` ids in its args: ``iteration`` (the root;
                      ``decode_rows``, ``chunks``, ``prefill_tokens``) >
                      ``schedule`` (``preempted``), ``chunk`` (per prefill
                      chunk, ``rid``; ``start``, ``length``, ``last``) >
                      ``chunk.inputs``, ``chunk.layers``, ``sample``;
                      ``decode.inputs`` (``width``; twice: the block
                      tables, then their copies), ``decode.layers``
                      (``graphed``: 1 where the step replayed the
                      piecewise CUDA graphs),
                      ``sample`` (``rows``) > ``sample.launch``,
                      ``sample.wait`` (the copies of the tokens to the
                      host, the step's one wait on the device); ``emit``
                      (``finished``). ``deliver``
                      (``chunks``), a root of its own, is
                      ``LLMService.poll`` building what it hands back; a
                      virtual-clock backend's ``iteration`` is one flat
                      event
``req``               (also) ``delivered``: ``LLMService.poll`` handed a
                      request its first token; ``first_token`` is stamped
                      when that token was sampled
====================  =====================================================
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, List, Optional

# Chrome trace-event phases used here: X=complete, i=instant,
# b/e=async span begin/end, M=metadata (added by the exporter)
PH_COMPLETE = "X"
PH_INSTANT = "i"
PH_BEGIN = "b"
PH_END = "e"


def profiler_clock() -> float:
    """Seconds of the Unix epoch (``time.time_ns``): the clock that
    ``torch.profiler`` stamps host events with (a profile's
    ``kineto_results.trace_start_ns()`` plus an event's ``time_range``, in
    ns). As a float it resolves about 0.24 us."""
    return time.time_ns() / 1e9


class Event:
    """One typed trace event. ``ts``/``dur`` are seconds on the emitting
    backend's clock; ``instance`` is the serving-instance track; ``rid``
    keys per-request async spans; ``it`` is the engine iteration the event
    belongs to (correlates scheduler decisions with their iteration)."""

    __slots__ = ("ts", "cat", "name", "ph", "instance", "rid", "it", "dur",
                 "args")

    def __init__(self, ts: float, cat: str, name: str, ph: str,
                 instance: int, rid: Optional[int], it: int,
                 dur: Optional[float], args: Optional[dict]):
        self.ts = ts
        self.cat = cat
        self.name = name
        self.ph = ph
        self.instance = instance
        self.rid = rid
        self.it = it
        self.dur = dur
        self.args = args

    def __repr__(self) -> str:  # debugging/test aid
        return (f"Event({self.ts:.6f}, {self.cat}.{self.name}, ph={self.ph},"
                f" inst={self.instance}, rid={self.rid}, it={self.it},"
                f" args={self.args})")


class Tracer:
    """Ring buffer of :class:`Event`. One per serving instance; a router
    assigns ``instance`` ids and merges buffers at export.

    ``clock``: callable returning the owner's current time in seconds
    (virtual clocks pass their own — sim traces never touch wall time);
    wall-clock owners keep the default, :func:`profiler_clock`.
    ``iteration`` is owner-updated per step so every event carries the
    iteration it belongs to.
    """

    def __init__(self, capacity: int = 131_072, *,
                 clock: Callable[[], float] = profiler_clock,
                 instance: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.clock = clock
        self.instance = instance
        self.iteration = 0
        self._buf: List[Event] = []
        self._head = 0  # next overwrite slot once the ring is full
        self.dropped = 0
        self.emitted = 0
        # open spans, innermost last: (id, parent id, cat, name, rid, start)
        self._open: List[tuple] = []
        self._spans = 0  # the last span id handed out

    # -- emission ---------------------------------------------------------------

    def _ts(self, ts: Optional[float]) -> float:
        return self.clock() if ts is None else ts

    def _push(self, ev: Event) -> None:
        self.emitted += 1
        if len(self._buf) < self.capacity:
            self._buf.append(ev)
        else:
            self._buf[self._head] = ev
            self._head = (self._head + 1) % self.capacity
            self.dropped += 1

    def instant(self, cat: str, name: str, *, rid: Optional[int] = None,
                ts: Optional[float] = None, **args) -> None:
        """A point-in-time event (scheduler decision, lease transition)."""
        self._push(Event(self._ts(ts), cat, name, PH_INSTANT, self.instance,
                         rid, self.iteration, None, args or None))

    def complete(self, cat: str, name: str, *, dur: float,
                 rid: Optional[int] = None, ts: Optional[float] = None,
                 **args) -> None:
        """A duration slice on the instance track (``ts`` is the start)."""
        self._push(Event(self._ts(ts), cat, name, PH_COMPLETE, self.instance,
                         rid, self.iteration, dur, args or None))

    def begin(self, cat: str, name: str, rid: int, *,
              ts: Optional[float] = None, **args) -> None:
        """Open a per-request async span (closed by :meth:`end`)."""
        self._push(Event(self._ts(ts), cat, name, PH_BEGIN, self.instance,
                         rid, self.iteration, None, args or None))

    def end(self, cat: str, name: str, rid: int, *,
            ts: Optional[float] = None, **args) -> None:
        self._push(Event(self._ts(ts), cat, name, PH_END, self.instance,
                         rid, self.iteration, None, args or None))

    def enter(self, cat: str, name: str, *, rid: Optional[int] = None,
              root: bool = False) -> None:
        """Open a span on the instance track, inside the innermost open one;
        :meth:`exit` closes it. ``root`` first drops any span that an
        exception left open."""
        t0 = self.clock()
        if root:
            self._open.clear()
        self._spans += 1
        parent = self._open[-1][0] if self._open else None
        self._open.append((self._spans, parent, cat, name, rid, t0))

    def exit(self, **args) -> None:
        """Close the innermost open span as a complete event, with ``args``
        (the counters at its end) and its ``span`` and ``parent`` ids."""
        t1 = self.clock()
        sid, parent, cat, name, rid, t0 = self._open.pop()
        args["span"] = sid
        args["parent"] = parent
        self._push(Event(t0, cat, name, PH_COMPLETE, self.instance, rid,
                         self.iteration, t1 - t0, args))

    # -- access -----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._buf)

    def events(self) -> List[Event]:
        """Events in emission order (oldest first, ring unwound)."""
        return self._buf[self._head:] + self._buf[:self._head]

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events())


_profiled: Optional[Tracer] = None


def keep_profiled(tracer: Tracer) -> None:
    """Keep ``tracer`` reachable as the newest that recorded under a
    ``torch.profiler`` session (see the module's docstring)."""
    global _profiled
    _profiled = tracer


def last_profiled() -> Optional[Tracer]:
    """The tracer kept by :func:`keep_profiled`, or None; its events stay
    in it."""
    return _profiled


def merge_events(tracers) -> List[Event]:
    """Merge several tracers' buffers onto one timeline, ordered by
    timestamp (ties keep per-tracer emission order — Python's sort is
    stable). The router uses this to splice child instances' traces."""
    evs: List[Event] = []
    for t in tracers:
        if t is not None:
            evs.extend(t.events())
    evs.sort(key=lambda e: e.ts)
    return evs
