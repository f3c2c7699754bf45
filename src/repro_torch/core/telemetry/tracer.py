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
  constructed. ``tools/validate_trace.py --check-disabled-overhead``
  asserts this structurally (zero allocations attributed to this module).
* **Bounded memory.** Events land in a fixed-capacity ring; once full the
  oldest events are overwritten (``dropped`` counts them). Exporters see
  events in emission order.
* **Clock-agnostic.** Every event is stamped through the owner's clock:
  a virtual-clock backend passes its ``clock`` callable (sim traces are
  perfectly reproducible — no wall time anywhere), a wall-clock engine
  updates the ``now`` attribute at each ``step``. A cluster router merges
  per-child tracers onto one timeline by sorting on these timestamps.

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
``engine``            per-iteration ``iteration`` complete events (one
                      track per instance), engine ``chunk`` executions
====================  =====================================================
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

# Chrome trace-event phases used here: X=complete, i=instant,
# b/e=async span begin/end, C=counter, M=metadata (added by the exporter)
PH_COMPLETE = "X"
PH_INSTANT = "i"
PH_BEGIN = "b"
PH_END = "e"
PH_COUNTER = "C"


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
    (virtual clocks pass their own — sim traces never touch wall time).
    ``None`` means the owner updates :attr:`now` explicitly (wall-clock
    engines set it to the caller-supplied ``now`` each ``step``).
    ``iteration`` is likewise owner-updated per step so every event carries
    the iteration it belongs to.
    """

    def __init__(self, capacity: int = 131_072, *,
                 clock: Optional[Callable[[], float]] = None,
                 instance: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.clock = clock
        self.instance = instance
        self.now = 0.0
        self.iteration = 0
        self._buf: List[Event] = []
        self._head = 0  # next overwrite slot once the ring is full
        self.dropped = 0
        self.emitted = 0

    # -- emission ---------------------------------------------------------------

    def _ts(self, ts: Optional[float]) -> float:
        if ts is not None:
            return ts
        return self.clock() if self.clock is not None else self.now

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

    def counter(self, name: str, *, ts: Optional[float] = None,
                **values) -> None:
        """A counter-track sample (rendered as stacked area in Perfetto)."""
        self._push(Event(self._ts(ts), "metrics", name, PH_COUNTER,
                         self.instance, None, self.iteration, None, values))

    # -- access -----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._buf)

    def events(self) -> List[Event]:
        """Events in emission order (oldest first, ring unwound)."""
        return self._buf[self._head:] + self._buf[:self._head]

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events())


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
