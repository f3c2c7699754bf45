"""Unified serving front-end: one API over the real engine and the simulator.

The paper's serving study (§III.E) compares ORCA/vLLM/InfiniteLLM as
*services*; this module is the service surface the rest of the repo talks to,
modeled on vLLM's ``LLM`` / ``SamplingParams`` split:

* :class:`SamplingParams` — per-request decoding knobs (temperature, top-k,
  top-p, stop tokens, best-of-n, seed). Sampling is no longer an engine-global
  ``EngineConfig.temperature``; every request carries its own params and the
  fused decode samples all slots with vectorized per-slot parameters.
* :class:`RequestOutput` / :class:`CompletionChunk` — results. ``generate``
  returns finished outputs with finish reasons and latency metrics;
  ``stream`` yields per-iteration chunks as the engine steps.
* :class:`LLMService` — the front-end. ``generate`` (blocking), ``stream``
  (iterator driven by backend ``step()``), and ``submit``/``poll`` for
  open-loop arrival traces (the Fig. 9/10 benchmarks).

Backends implement the :class:`ServingBackend` protocol. In this package
that is ``PagedEngine`` (wall-clock or caller-supplied time), and a whole
cluster: ``repro_torch.serving.router.RouterBackend`` multiplexes N engines
behind this protocol, reporting per-request placement via
``RequestMetrics.instance_id`` and per-instance aggregates via
``ServiceStats.per_instance``. The cost-model simulator that ``repro`` puts
behind the same protocol comes with a later slice of the port.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import (Dict, Iterable, Iterator, List, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

from repro_torch.core.scheduling.request import Request
from repro_torch.core.telemetry import percentile

# finish reasons (Request.finish_reason / RequestOutput.finish_reason)
FINISH_STOP = "stop"                  # hit one of SamplingParams.stop_token_ids
FINISH_EOS = "eos"                    # hit the eos token
FINISH_LENGTH = "length"              # hit max_new_tokens
FINISH_DROPPED = "preempted-dropped"  # evicted past the preemption budget
FINISH_REASONS = (FINISH_STOP, FINISH_EOS, FINISH_LENGTH, FINISH_DROPPED)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters (vLLM-style).

    ``temperature <= 0`` means greedy. ``top_k = 0`` / ``top_p = 1.0``
    disable the respective filters. ``n > 1`` draws n parallel samples whose
    KV is shared through the paging layer's copy-on-write forks. ``seed``
    pins the request's sample stream (independent of batch composition and
    slot placement); ``None`` derives one from the request id.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_token_ids: Tuple[int, ...] = ()
    eos_token: Optional[int] = None
    max_new_tokens: int = 16
    n: int = 1
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "stop_token_ids",
                           tuple(self.stop_token_ids or ()))
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = disabled)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.n < 1:
            raise ValueError("n must be >= 1")

    def for_sample(self, k: int) -> "SamplingParams":
        """Params for best-of sibling ``k`` (k >= 1): same knobs, n=1, and a
        decorrelated seed so siblings draw distinct streams."""
        seed = None if self.seed is None else (self.seed + 7919 * k) & 0x7FFFFFFF
        return dataclasses.replace(self, n=1, seed=seed)


@dataclasses.dataclass
class CompletionChunk:
    """Tokens produced for one request during one service poll."""

    request_id: int
    token_ids: List[int]           # new tokens since the previous chunk
    n_generated: int               # cumulative tokens so far
    finished: bool = False
    finish_reason: Optional[str] = None
    time: Optional[float] = None   # backend clock (None = wall-clock backend)
    # per-token log p(token) aligned with token_ids, streamed incrementally;
    # None when the backend does not score tokens (the cost-model simulator)
    logprobs: Optional[List[float]] = None


@dataclasses.dataclass
class RequestMetrics:
    arrival_time: float
    queue_time: Optional[float]    # arrival -> first scheduled
    ttft: Optional[float]          # arrival -> first token (spans all
    #                                prefill chunks of a chunked prefill)
    tbt: Optional[float]           # mean time between output tokens
    e2e: Optional[float]           # arrival -> finish
    normalized_latency: Optional[float]  # e2e / output tokens (Fig. 9 metric)
    preemptions: int = 0
    num_cached_tokens: int = 0     # prompt tokens served from the radix cache
    # serving instance the request ran on (RouterBackend placement; None
    # under a single-backend service)
    instance_id: Optional[int] = None
    # worst gap between consecutive output tokens: the stall a decode
    # suffers when someone's prefill monopolizes an iteration
    max_tbt: Optional[float] = None
    # prefill-in-flight duration: first scheduled chunk -> first token
    prefill_time: Optional[float] = None


@dataclasses.dataclass
class CompletionSample:
    """One of a request's ``n`` parallel samples."""

    token_ids: List[int]
    cumulative_logprob: float
    finish_reason: str
    # per-token logprobs aligned with token_ids (None on the simulator)
    token_logprobs: Optional[List[float]] = None


@dataclasses.dataclass
class RequestOutput:
    """Final result for one submitted request. With ``n > 1`` all samples are
    kept (sorted best-first by cumulative logprob); ``token_ids`` /
    ``finish_reason`` mirror the best sample."""

    request_id: int
    prompt_len: int
    token_ids: List[int]
    finish_reason: str
    metrics: RequestMetrics
    cumulative_logprob: float = 0.0
    samples: List[CompletionSample] = dataclasses.field(default_factory=list)

    @property
    def n_generated(self) -> int:
        return len(self.token_ids)


@runtime_checkable
class ServingBackend(Protocol):
    """What LLMService needs from an execution backend. Implemented by
    ``PagedEngine`` (real model, wall-clock / caller time) and ``SimBackend``
    (cost model, virtual clock)."""

    def add_request(self, req: Request) -> None: ...

    def step(self, now: Optional[float] = None) -> List[Request]:
        """Run ONE iteration; returns requests finished this iteration."""
        ...

    @property
    def has_work(self) -> bool: ...

    def clock(self) -> Optional[float]:
        """Backend time. ``None`` = wall-clock backend (caller passes ``now``
        to :meth:`LLMService.poll`); a float = virtual clock the service may
        fast-forward across idle gaps."""
        ...


@dataclasses.dataclass
class ServiceStats:
    """Aggregates over a batch of finished outputs (Fig. 9-style metrics)."""

    n_requests: int = 0
    n_finished: int = 0
    n_dropped: int = 0
    total_tokens: int = 0
    makespan: float = 0.0
    mean_ttft: float = float("inf")
    mean_normalized_latency: float = float("inf")
    p99_normalized_latency: float = float("inf")
    throughput_tokens_per_s: float = 0.0
    preemptions: int = 0
    prefix_hit_rate: Optional[float] = None
    # P99 of per-request WORST inter-token gaps — the decode-stall tail
    # chunked prefill targets (a solo long prefill dominates it)
    p99_tbt: float = float("inf")
    # mean excess of a request's worst gap over its own average gap, in ms:
    # ~0 for an evenly-paced decode, large when decodes stall behind
    # someone's prefill
    prefill_stall_ms: float = 0.0
    # RouterBackend services: per-instance breakdown (requests placed,
    # iterations, load, cache stats), keyed by instance id
    per_instance: Optional[Dict[int, Dict]] = None
    # telemetry-enabled backends: per-iteration metric timelines, keyed by
    # instance id (one row per step; see repro_torch.core.telemetry)
    timelines: Optional[Dict[int, List[Dict]]] = None
    # disaggregated routers: the same rows grouped per instance role
    # (prefill / decode / mixed) — the per-role split of the cluster
    role_timelines: Optional[Dict[str, List[Dict]]] = None

    @property
    def completed_frac(self) -> float:
        return self.n_finished / max(self.n_requests, 1)


@dataclasses.dataclass
class _Live:
    req: Request
    parent_id: int
    reported: int = 0
    finished: bool = False


class LLMService:
    """vLLM-style front-end over a :class:`ServingBackend`.

    Closed-loop use::

        svc = LLMService(PagedEngine(cfg, params, ecfg))
        outs = svc.generate(prompts, SamplingParams(temperature=0.8, top_p=0.9))

    Open-loop traces (``submit`` with arrival times, then ``poll``)::

        for r in requests:
            svc.submit(r.prompt, params, arrival_time=r.arrival_time)
        while svc.pending:
            for chunk in svc.poll():
                ...
    """

    def __init__(self, backend: ServingBackend, *,
                 default_params: Optional[SamplingParams] = None):
        self.backend = backend
        self.default_params = default_params or SamplingParams()
        self._next_id = 0
        self._queue: List[Request] = []   # future arrivals, sorted by time
        self._live: Dict[int, _Live] = {}
        self._families: Dict[int, List[int]] = {}  # parent -> member ids
        self._results: Dict[int, RequestOutput] = {}
        self._order: List[int] = []       # submission order of parent ids
        self._t0: Optional[float] = None  # wall-clock origin (engine backend)
        self._progressed = False          # last poll made progress

    # -- submission -------------------------------------------------------------

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               arrival_time: float = 0.0) -> int:
        """Queue one prompt; returns the request id. With ``params.n > 1``,
        sibling requests are created for the backend to COW-fork off the
        parent's prefill."""
        params = params or self.default_params
        rid = self._fresh_id()
        parent = Request(rid, arrival_time, list(prompt),
                         max_new_tokens=params.max_new_tokens,
                         eos_token=params.eos_token,
                         sampling=params if params.n == 1
                         else params.for_sample(0))
        members = [parent]
        for k in range(1, params.n):
            child = Request(self._fresh_id(), arrival_time, list(prompt),
                            max_new_tokens=params.max_new_tokens,
                            eos_token=params.eos_token,
                            sampling=params.for_sample(k), parent_id=rid)
            members.append(child)
        self._families[rid] = [m.request_id for m in members]
        self._order.append(rid)
        for m in members:
            self._enqueue(m)
        return rid

    def submit_request(self, req: Request,
                       params: Optional[SamplingParams] = None) -> int:
        """Queue a pre-built :class:`Request` (trace replay). The request's
        own ``max_new_tokens`` / ``eos_token`` / ``arrival_time`` are kept;
        ``params`` (optional) attaches sampling knobs."""
        if params is not None:
            req.sampling = params
        self._next_id = max(self._next_id, req.request_id + 1)
        self._families[req.request_id] = [req.request_id]
        self._order.append(req.request_id)
        self._enqueue(req)
        return req.request_id

    def _fresh_id(self) -> int:
        rid = self._next_id
        self._next_id += 1
        return rid

    def _enqueue(self, req: Request) -> None:
        self._live[req.request_id] = _Live(
            req, req.parent_id if req.parent_id is not None
            else req.request_id)
        bisect.insort(self._queue, req, key=lambda r: r.arrival_time)

    # -- the drive loop ---------------------------------------------------------

    @property
    def pending(self) -> bool:
        return bool(self._queue) or \
            any(not s.finished for s in self._live.values())

    def poll(self, now: Optional[float] = None, *,
             collect: bool = True) -> List[CompletionChunk]:
        """Inject due arrivals, run ONE backend iteration, and return the
        chunks it produced. ``now`` is the caller's clock for wall-clock
        backends; virtual-clock backends keep their own time and are
        fast-forwarded across idle gaps. ``collect=False`` skips building
        per-token chunks (drain/replay: nobody consumes them)."""
        t = now if now is not None else self.backend.clock()
        if t is None:
            # wall-clock backend, no caller time: measure from first poll so
            # arrival_time=0 submissions get meaningful latency metrics
            if self._t0 is None:
                self._t0 = time.monotonic()
            t = time.monotonic() - self._t0
        injected = False
        while self._queue and self._queue[0].arrival_time <= t:
            self.backend.add_request(self._queue.pop(0))
            injected = True
        iters_before = getattr(self.backend, "iterations", None)
        finished = self.backend.step(t)
        chunks: Dict[int, CompletionChunk] = {}
        tnow = self.backend.clock()
        if collect:
            for rid, st in self._live.items():
                if st.finished:
                    continue
                total = st.req.full_output
                if len(total) > st.reported:
                    # stream per-token logprobs with the tokens when the
                    # backend scores them (req.logprobs stays aligned with
                    # full_output across preemptions)
                    lps = list(st.req.logprobs[st.reported:len(total)]) \
                        if len(st.req.logprobs) == len(total) else None
                    chunks[rid] = CompletionChunk(
                        rid, list(total[st.reported:]), len(total), time=tnow,
                        logprobs=lps)
                    st.reported = len(total)
        for req in finished:
            st = self._live.get(req.request_id)
            if st is None:
                continue
            st.finished = True
            if collect:
                ch = chunks.setdefault(req.request_id, CompletionChunk(
                    req.request_id, [], len(req.full_output), time=tnow))
                ch.finished = True
                ch.finish_reason = req.finish_reason
            self._maybe_complete_family(st.parent_id)
        stepped = iters_before is not None and \
            getattr(self.backend, "iterations", None) != iters_before
        self._progressed = bool(chunks) or bool(finished) or injected \
            or stepped
        if not self._progressed and self._queue and not self.backend.has_work:
            if self.backend.clock() is not None:
                # virtual clock idle before the next arrival: jump ahead
                self.backend.advance_to(self._queue[0].arrival_time)
                return self.poll(now, collect=collect)
            if now is None:
                # wall clock, service-owned time: sleep out the gap
                time.sleep(max(0.0, self._queue[0].arrival_time - t))
                return self.poll(None, collect=collect)
        return list(chunks.values())

    def drain(self, max_iters: int = 1_000_000) -> None:
        """Poll until every submitted request finished or the backend can
        make no further progress (e.g. a request that can never fit)."""
        idle = 0
        # without an `iterations` counter on the backend, token chunks are
        # the only progress signal — keep collecting them
        collect = not hasattr(self.backend, "iterations")
        for _ in range(max_iters):
            if not self.pending:
                return
            self.poll(collect=collect)
            if self._progressed:
                idle = 0
            else:
                idle += 1
                if idle >= 3:
                    return  # stalled: nothing scheduled, nothing arriving

    # -- blocking / streaming front doors ---------------------------------------

    def generate(self, prompts: Iterable[Sequence[int]],
                 params: Optional[SamplingParams] = None
                 ) -> List[RequestOutput]:
        """Submit ``prompts`` and block until all finish. One
        :class:`RequestOutput` per prompt, in order."""
        ids = [self.submit(p, params) for p in prompts]
        self.drain()
        return [self._take_result(i) for i in ids]

    def stream(self, prompts: Iterable[Sequence[int]],
               params: Optional[SamplingParams] = None
               ) -> Iterator[CompletionChunk]:
        """Submit ``prompts`` and yield chunks as the backend steps."""
        for p in prompts:
            self.submit(p, params)
        idle = 0
        while self.pending:
            chunks = self.poll()
            idle = 0 if self._progressed else idle + 1
            if not chunks and idle >= 3:
                return
            yield from chunks

    def replay(self, requests: Sequence[Request],
               params: Optional[SamplingParams] = None
               ) -> Tuple[List[RequestOutput], ServiceStats]:
        """Run an open-loop arrival trace to completion (virtual-clock
        backends). Returns per-request outputs (trace order) + aggregates."""
        ids = [self.submit_request(r, params) for r in
               sorted(requests, key=lambda r: r.arrival_time)]
        self.drain()
        stats = self.stats()
        return [self._results.get(i) for i in ids], stats

    # -- results ----------------------------------------------------------------

    def _maybe_complete_family(self, parent_id: int) -> None:
        members = self._families[parent_id]
        if not all(self._live[m].finished for m in members):
            return
        samples = []
        for m in members:
            req = self._live[m].req
            samples.append(CompletionSample(
                list(req.full_output), req.cumulative_logprob,
                req.finish_reason or FINISH_LENGTH,
                token_logprobs=list(req.logprobs)
                if len(req.logprobs) == len(req.full_output) else None))
        samples.sort(key=lambda s: -s.cumulative_logprob)
        parent = self._live[parent_id].req
        best = samples[0]
        self._results[parent_id] = RequestOutput(
            request_id=parent_id,
            prompt_len=parent.prompt_len,
            token_ids=best.token_ids,
            finish_reason=best.finish_reason,
            metrics=_metrics_of(parent),
            cumulative_logprob=best.cumulative_logprob,
            samples=samples,
        )
        for m in members:
            del self._live[m]

    def _take_result(self, rid: int) -> RequestOutput:
        try:
            return self._results.pop(rid)
        except KeyError:
            raise RuntimeError(
                f"request {rid} did not finish (backend stalled — prompt "
                f"larger than the backend's memory, or drain() gave up)")

    def stats(self) -> ServiceStats:
        """Aggregate metrics over all completed outputs so far."""
        outs = list(self._results.values())
        s = ServiceStats(n_requests=len(self._order))
        s.n_finished = len(outs)
        s.n_dropped = sum(1 for o in outs
                          if o.finish_reason == FINISH_DROPPED)
        done = [o for o in outs if o.finish_reason != FINISH_DROPPED]
        s.total_tokens = sum(o.n_generated for o in done)
        ttfts = [o.metrics.ttft for o in outs if o.metrics.ttft is not None]
        if ttfts:
            s.mean_ttft = sum(ttfts) / len(ttfts)
        lats = [o.metrics.normalized_latency for o in done
                if o.metrics.normalized_latency is not None]
        if lats:
            s.mean_normalized_latency = sum(lats) / len(lats)
        s.p99_normalized_latency = percentile(lats, 99)
        worst = [o.metrics.max_tbt for o in done
                 if o.metrics.max_tbt is not None]
        s.p99_tbt = percentile(worst, 99)
        stalls = [max(0.0, o.metrics.max_tbt - o.metrics.tbt) for o in done
                  if o.metrics.max_tbt is not None
                  and o.metrics.tbt is not None]
        if stalls:
            s.prefill_stall_ms = 1e3 * sum(stalls) / len(stalls)
        clk = self.backend.clock()
        if clk is not None:
            s.makespan = clk
        elif done:
            s.makespan = max(o.metrics.e2e + o.metrics.arrival_time
                             for o in done if o.metrics.e2e is not None)
        if s.makespan > 0:
            s.throughput_tokens_per_s = s.total_tokens / s.makespan
        s.preemptions = getattr(self.backend, "preemptions", 0) or \
            sum(o.metrics.preemptions for o in outs)
        pc = getattr(self.backend, "prefix_cache", None)
        if pc is not None:
            s.prefix_hit_rate = pc.hit_rate
        inst = getattr(self.backend, "instance_stats", None)
        if inst is not None:
            s.per_instance = inst()
        tl = self.metrics_timelines()
        if tl:
            s.timelines = tl
        rt = getattr(self.backend, "role_timelines", None)
        if rt is not None:
            grouped = rt()
            if grouped:
                s.role_timelines = grouped
        return s

    # -- telemetry ----------------------------------------------------------------

    def metrics_timelines(self) -> Dict[int, List[Dict]]:
        """Per-instance metric timelines from a telemetry-enabled backend
        (empty when telemetry is off). Routers report one timeline per
        child instance; single backends report under instance 0."""
        fn = getattr(self.backend, "metrics_timelines", None)
        if fn is not None:
            return fn()
        m = getattr(self.backend, "metrics", None)
        return {0: m.rows()} if m is not None else {}

    def trace_events(self) -> list:
        """All tracer events from a telemetry-enabled backend (empty when
        telemetry is off), merged across instances for routers."""
        fn = getattr(self.backend, "trace_events", None)
        if fn is not None:
            return fn()
        tr = getattr(self.backend, "trace", None)
        return tr.events() if tr is not None else []

    def export_trace(self, path: str) -> int:
        """Write the backend's trace as Chrome/Perfetto trace-event JSON
        (open in https://ui.perfetto.dev). Returns the event count."""
        from repro_torch.core.telemetry import export_chrome_trace
        events = self.trace_events()
        export_chrome_trace(events, path)
        return len(events)

    def export_metrics_csv(self, path: str) -> int:
        """Write per-iteration metric timelines as CSV (one row per
        instance-iteration). Returns the row count."""
        from repro_torch.core.telemetry import export_metrics_csv
        return export_metrics_csv(self.metrics_timelines(), path)


def _metrics_of(req: Request) -> RequestMetrics:
    ttft = None if req.first_token_time is None else \
        req.first_token_time - req.arrival_time
    e2e = None if req.finish_time is None else \
        req.finish_time - req.arrival_time
    queue = None if req.scheduled_time is None else \
        req.scheduled_time - req.arrival_time
    tbt = None
    if req.finish_time is not None and req.first_token_time is not None \
            and req.total_generated > 1:
        tbt = (req.finish_time - req.first_token_time) / \
            (req.total_generated - 1)
    prefill_time = None
    if req.first_token_time is not None and req.scheduled_time is not None:
        prefill_time = req.first_token_time - req.scheduled_time
    return RequestMetrics(
        arrival_time=req.arrival_time, queue_time=queue, ttft=ttft, tbt=tbt,
        e2e=e2e, normalized_latency=req.normalized_latency(),
        preemptions=req.preemptions,
        num_cached_tokens=req.num_cached_tokens,
        instance_id=req.instance_id,
        max_tbt=req.max_tbt if req.total_generated > 1 else None,
        prefill_time=prefill_time)
