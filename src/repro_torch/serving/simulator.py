"""Event-driven serving simulator (paper §III.E), a copy of
``repro.serving.simulator`` with its imports changed.

The paper tabulates results from the ORCA/vLLM/InfiniteLLM papers because the
authors "lacked the computing abilities" to run the systems. We instead
*simulate* the serving cluster with an explicit iteration cost model, so
Fig. 9 / Fig. 10-style sweeps run on a CPU while exercising the real
scheduler + allocator code paths from ``repro_torch.core``. It holds no
tensor and needs no device.

Cost model (per engine iteration):
  t_iter = t_fixed + c_token * (#tokens through MLP/linear, the selective-
           batching flattened buffer) + c_ctx * Σ context lens (attention
           reads) [+ c_remote * Σ remote context (DistKV borrowed rBlocks)]

:class:`CostModel`'s defaults are the reference's own assumption, "A100-ish
serving OPT-13B": they were measured on no card, and are kept bit for bit
so that this copy's results equal the reference's. The terms of full-width
OPT-13B on the port's engine on an H100, fitted by ``chip_smoke.py``'s sim
phase, are recorded in PERF.md; pass them as ``CostModel(t_fixed=...,
c_token=..., c_ctx=...)``.

All schedulers/allocators are the *real* implementations — the simulator only
replaces the model execution with the cost model and draws output lengths
from request metadata.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.distkv.gmanager import GManager
from repro_torch.core.distkv.netmodel import NetworkModel
from repro_torch.core.distkv.rmanager import RManager
from repro_torch.core.paging.allocator import (BlockAllocator,
                                         ContiguousPreallocAllocator,
                                         OutOfBlocks)
from repro_torch.core.prefixcache.radix import PrefixCache
from repro_torch.core.scheduling.batch import BatchScheduler
from repro_torch.core.scheduling.iteration import IterationScheduler
from repro_torch.core.scheduling.request import Phase, Request
from repro_torch.core.telemetry import MetricsRegistry, Tracer, percentile


@dataclasses.dataclass
class CostModel:
    """Seconds of one engine iteration from what it computes. The defaults
    are the reference's assumed A100-like terms for OPT-13B, measured on no
    card; the H100's own terms (full-width OPT-13B on the port's engine)
    are in PERF.md."""

    t_fixed: float = 0.004       # kernel-launch/sync floor per iteration
    c_token: float = 12e-6       # s per flattened token (linear layers)
    c_ctx: float = 18e-9         # s per cached token read (attention)
    # borrowed rBlocks: DistAttention computes the micro-attention where the
    # block lives and ships only (o, m, l) partials, so the penalty is the
    # merge + coordination, not a remote read of the whole page (~35% extra)
    c_remote: float = 6e-9

    def iteration_time(self, n_tokens: int, sum_ctx: int,
                       sum_remote_ctx: int = 0) -> float:
        return (self.t_fixed + self.c_token * n_tokens +
                self.c_ctx * sum_ctx + self.c_remote * sum_remote_ctx)

    @staticmethod
    def prefill_read_tokens(start: int, length: int) -> int:
        """Attention KV reads of one prefill chunk computing prompt tokens
        ``[start, start+length)``: every chunk token reads the ``start``
        tokens already in the cache (earlier chunks / radix-cached prefix)
        plus its causal predecessors within the chunk. Charged via ``c_ctx``
        like decode reads, so N chunks of a prompt cost the same attention
        total as one monolithic prefill (start=0, length=P: P*(P-1)/2) —
        chunking only adds per-iteration ``t_fixed``, which is the real
        hardware trade."""
        return length * start + length * (length - 1) // 2


@dataclasses.dataclass
class SimResult:
    requests: List[Request]
    makespan: float
    peak_memory_frac: float = 0.0
    kv_utilization: float = 1.0
    preemptions: int = 0
    rejected: int = 0
    # radix prefix-cache stats (None when the cache is disabled)
    prefix_hit_rate: Optional[float] = None
    cached_pages: int = 0
    # multi-instance router runs: per-instance breakdown + adopted pages
    per_instance: Optional[Dict[int, Dict]] = None
    adopted_pages: int = 0
    # zero-copy runs: pages served in place via borrowed rBlocks, and the
    # modeled network time spent on copies + lease RPCs
    borrowed_pages: int = 0
    net_time: float = 0.0
    # host swap tier: swap-out / swap-in events and total PCIe time charged
    swapped_out: int = 0
    swapped_in: int = 0
    swap_time: float = 0.0
    # speculative swap-outs cancelled because pressure receded (the pages
    # never left the device)
    swap_cancels: int = 0
    # disaggregated runs: prefill->decode KV handoffs by path, and the
    # per-role metric timelines (role -> time-ordered rows)
    handoffs_migrated: int = 0
    handoffs_leased: int = 0
    handoff_deferrals: int = 0
    handoff_fallbacks: int = 0
    role_timelines: Optional[Dict[str, List[Dict]]] = None
    # telemetry (``trace=True`` runs only): merged tracer events on the
    # virtual clock, and per-instance metric timelines (instance -> rows)
    events: Optional[List] = None
    timelines: Optional[Dict[int, List[Dict]]] = None

    @property
    def max_tbts(self) -> np.ndarray:
        """Per-request worst inter-token gap (>= 2 tokens emitted) — the
        decode-stall metric chunked prefill targets."""
        return np.array([r.max_tbt for r in self.finished
                         if r.total_generated >= 2])

    @property
    def p99_tbt(self) -> float:
        """P99 of per-request worst inter-token gaps: a decode stalled
        behind a solo long prefill dominates this tail."""
        return float(percentile(self.max_tbts, 99))

    @property
    def finished(self) -> List[Request]:
        return [r for r in self.requests if r.finish_time is not None]

    @property
    def mean_ttft(self) -> float:
        """Mean time-to-first-token (prefill queueing + compute)."""
        ts = [r.first_token_time - r.arrival_time for r in self.requests
              if r.first_token_time is not None]
        return float(np.mean(ts)) if ts else float("inf")

    @property
    def completed_frac(self) -> float:
        return len(self.finished) / max(len(self.requests), 1)

    @property
    def normalized_latencies(self) -> np.ndarray:
        return np.array([r.normalized_latency() for r in self.finished])

    @property
    def mean_normalized_latency(self) -> float:
        ls = self.normalized_latencies
        return float(ls.mean()) if len(ls) else float("inf")

    @property
    def p99_normalized_latency(self) -> float:
        return float(percentile(self.normalized_latencies, 99))

    @property
    def throughput_tokens_per_s(self) -> float:
        """Useful throughput: tokens of *finished* requests only."""
        tok = sum(r.total_generated for r in self.finished)
        return tok / self.makespan if self.makespan > 0 else 0.0


def make_workload(n: int, *, rate: float, dist: str = "sharegpt",
                  seed: int = 0, long_frac: float = 0.0,
                  long_len: int = 16_384,
                  max_len: int = 2048,
                  materialize_tokens: bool = False,
                  vocab: int = 32_000) -> List[Request]:
    """Poisson arrivals; prompt/output lengths follow the named distribution.

    ``dist``: "sharegpt" (long, heavy-tailed outputs) | "alpaca" (short).
    ``long_frac``: fraction of requests with ~``long_len`` total context
    (the Fig. 10 knob: 1% / 10% long requests).
    ``materialize_tokens``: fill ``prompt`` with (unique) random token ids so
    the radix prefix cache has something to key on — the unique-prompt
    baseline for the prefix-cache sweep."""
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0 / rate, n))
    reqs = []
    for i in range(n):
        if dist == "sharegpt":
            p = int(np.clip(rng.lognormal(4.9, 0.9), 4, max_len - 2))
            o = int(np.clip(rng.lognormal(5.2, 0.9), 1, max_len - p - 1))
        elif dist == "alpaca":
            p = int(np.clip(rng.lognormal(3.0, 0.8), 4, max_len - 2))
            o = int(np.clip(rng.lognormal(3.7, 0.9), 1, max_len - p - 1))
        else:
            raise ValueError(dist)
        if long_frac and rng.random() < long_frac:
            # long-context requests are prompt-heavy (long document in,
            # short answer out), as in the InfiniteLLM evaluation
            total = long_len
            p = max(4, int(total * rng.uniform(0.90, 0.97)))
            o = max(1, total - p)
        prompt = rng.integers(0, vocab, p).tolist() if materialize_tokens \
            else []
        reqs.append(Request(i, float(arr[i]), prompt, max_new_tokens=o,
                            prompt_len=p))
    return reqs


def make_shared_prefix_workload(n: int, *, rate: float, n_groups: int = 4,
                                prefix_len: int = 512, suffix_len: int = 64,
                                out_len: int = 128, seed: int = 0,
                                group_draw: str = "cyclic",
                                vocab: int = 32_000) -> List[Request]:
    """Shared-system-prompt traffic: each request is one of ``n_groups``
    shared system prompts plus a unique user suffix (real token ids so the
    radix cache can key on pages).

    ``group_draw``: "cyclic" assigns request ``i`` to group ``i % n_groups``
    (deterministic, good for single-instance cache studies); "random" draws
    the group per request (a stochastic tenant mix — required for honest
    multi-instance routing comparisons, where a cyclic assignment can
    accidentally align with a round-robin placement and look affine)."""
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0 / rate, n))
    prefixes = [rng.integers(0, vocab, prefix_len).tolist()
                for _ in range(n_groups)]
    reqs = []
    for i in range(n):
        g = i % n_groups if group_draw == "cyclic" else \
            int(rng.integers(0, n_groups))
        suf = int(rng.integers(max(1, suffix_len // 2), suffix_len + 1))
        prompt = prefixes[g] + rng.integers(0, vocab, suf).tolist()
        o = int(np.clip(rng.lognormal(np.log(out_len), 0.4), 1, 4 * out_len))
        reqs.append(Request(i, float(arr[i]), prompt, max_new_tokens=o))
    return reqs


def make_few_shot_workload(n: int, *, rate: float, template_len: int = 1024,
                           question_len: int = 48, out_len: int = 32,
                           seed: int = 0, vocab: int = 32_000) -> List[Request]:
    """Few-shot template traffic: every request shares ONE long in-context
    example block and differs only in a short question (classification /
    extraction serving, the highest-hit-rate scenario)."""
    return make_shared_prefix_workload(
        n, rate=rate, n_groups=1, prefix_len=template_len,
        suffix_len=question_len, out_len=out_len, seed=seed, vocab=vocab)


def make_multi_turn_workload(n_sessions: int, n_turns: int, *, rate: float,
                             system_len: int = 128, user_len: int = 48,
                             reply_len: int = 96, think_time: float = 2.0,
                             service_time_per_token: float = 0.005,
                             seed: int = 0,
                             vocab: int = 32_000) -> List[Request]:
    """Multi-turn chat: turn ``t`` resends the full history (system prompt +
    prior user/assistant turns) plus a new user message, as chat clients do.
    Assistant replies are synthesized at build time (the simulator emits
    placeholder tokens, not real ones); the radix cache reuses the history's
    full pages across turns, so the hit rate grows with conversation depth.

    A real client cannot send turn ``t+1`` before turn ``t``'s reply streamed
    back, so the next arrival is spaced by an estimate of the reply's service
    time (``out_tokens * service_time_per_token``) plus ``think_time``. The
    estimate is approximate — under heavy congestion a turn may still arrive
    before its predecessor finished and simply miss the cache for the newest
    history pages."""
    rng = np.random.default_rng(seed)
    starts = np.cumsum(rng.exponential(1.0 / rate, n_sessions))
    reqs = []
    rid = 0
    for s in range(n_sessions):
        history = rng.integers(0, vocab, system_len).tolist()
        t_arr = float(starts[s])
        for _ in range(n_turns):
            user = rng.integers(
                0, vocab, int(rng.integers(max(1, user_len // 2),
                                           user_len + 1))).tolist()
            prompt = history + user
            o = int(rng.integers(max(1, reply_len // 2), reply_len + 1))
            reqs.append(Request(rid, t_arr, list(prompt), max_new_tokens=o))
            rid += 1
            # stand-in for the assistant reply the client would resend
            history = prompt + rng.integers(0, vocab, o).tolist()
            t_arr += o * service_time_per_token + think_time
    return sorted(reqs, key=lambda r: r.arrival_time)


# ---------------------------------------------------------------------------
# paged / iteration-level simulation (vLLM = paged; Orca variants = prealloc)
# ---------------------------------------------------------------------------

class SimBackend:
    """Cost-model ServingBackend: the *real* scheduler / allocator / radix
    tree driven on a virtual clock, with model execution replaced by the
    :class:`CostModel` (paper §III.E). Drop-in peer of ``PagedEngine``
    behind :class:`repro_torch.serving.api.LLMService` — benchmarks choose
    the backend by flag, not by import."""

    def __init__(self, *, num_blocks: int = 7000, block_size: int = 16,
                 max_running: int = 256, max_tokens_per_iter: int = 8192,
                 prefix_cache: bool = False,
                 max_preemptions: Optional[int] = None,
                 chunk_policy: str = "decode_first",
                 host_blocks: int = 0,
                 swap_mode: str = "sacrifice",
                 victim_policy: str = "lifo",
                 swap_overlap: bool = False,
                 speculative_swap: bool = False,
                 cache_spill_pages: int = 0,
                 cost: Optional[CostModel] = None,
                 net: Optional[NetworkModel] = None,
                 layout=None,
                 trace: bool = False):
        self.cost = cost or CostModel()
        # network/serialization model for cross-instance KV movement: the
        # router charges payload copies / lease RPCs via charge_network, and
        # step() adds the per-iteration partial-merge overhead of requests
        # decoding over borrowed rBlocks. None = network is free (the old
        # behavior, which flattered copy-mode sharing).
        self.net = net
        self.net_time = 0.0
        # the PCIe lane is always charged — a swap is never free, even when
        # the interconnect model is off (swap traffic rides host PCIe, not
        # the network; only the bandwidth figure is shared via NetworkModel)
        self.swap_net = net if net is not None else NetworkModel()
        # layout (optional KVPageLayout): the simulated arch's page-payload
        # schema. When set, every swap/copy charge uses the layout's true
        # bytes per page instead of the NetworkModel default — compressed
        # layouts (MLA latent pages) move ~10x fewer bytes, which flips
        # should_swap / victim_policy="cost" decisions at the margin. None
        # keeps the default-bytes behavior (and the committed swap-sweep
        # baselines) bit-identical.
        self.kv_layout = layout
        self.kv_page_bytes = layout.page_bytes(block_size) \
            if layout is not None else None
        self.swap_time_s = 0.0
        self.swapped_out = 0
        self.swapped_in = 0
        # overlap window: PCIe transfers hide behind the iteration's compute
        # (double-buffered DMA); only the surplus past the compute time is
        # charged on the virtual clock. Off = the serial model.
        self.swap_overlap = swap_overlap
        self.swap_cancels = 0
        self.allocator = BlockAllocator(num_blocks, block_size,
                                        host_blocks=host_blocks,
                                        layout=layout)
        self.prefix_cache = PrefixCache(
            self.allocator, spill_budget=cache_spill_pages) if prefix_cache \
            else None
        self.scheduler = IterationScheduler(
            self.allocator, max_running=max_running,
            max_tokens_per_iter=max_tokens_per_iter,
            prefix_cache=self.prefix_cache, max_preemptions=max_preemptions,
            chunk_policy=chunk_policy,
            # sim outputs are placeholder ids — adopting them into the radix
            # tree would cache meaningless pages
            cache_generated=False,
            swap_mode=swap_mode, victim_policy=victim_policy,
            # "auto" resolves per victim against the cost model: swap when
            # the PCIe round trip (out now + in later) undercuts recomputing
            # the victim's context from scratch
            swap_decider=self._swap_worth_it if swap_mode == "auto"
            else None,
            # victim_policy="cost" ranks candidates by this (eviction cost
            # per freed page) instead of queue position — only consulted by
            # the scheduler for the cost policy
            victim_cost_fn=self._victim_cost,
            speculative_swap=speculative_swap)
        self._now = 0.0
        self.iterations = 0
        self.preemptions = 0
        self.peak_memory_frac = 0.0
        self._utils: List[float] = []
        # telemetry: events are stamped through the VIRTUAL clock, so a
        # traced sim run is perfectly reproducible (no wall time anywhere)
        if trace:
            self.trace = Tracer(clock=self.clock)
            self.metrics = MetricsRegistry()
            self.scheduler.trace = self.trace
        else:
            self.trace = None
            self.metrics = None

    def _swap_worth_it(self, req: Request, n_pages: int) -> bool:
        """swap_mode="auto" decision: is this victim's KV worth the PCIe
        round trip? Recomputing its computed context costs linear-layer
        FLOPs plus the quadratic attention reads; swapping costs two
        transfers of its pages. Short contexts recompute, long ones swap —
        the crossover ``benchmarks/swap_sweep.py`` measures."""
        ctx = req.prefilled_len + req.n_generated
        recompute = self.cost.c_token * ctx + \
            self.cost.c_ctx * self.cost.prefill_read_tokens(0, ctx)
        return 2.0 * self.swap_net.swap_time(
            n_pages, page_bytes=self.kv_page_bytes) < recompute

    def _victim_cost(self, req: Request, table) -> float:
        """victim_policy="cost" raw eviction bill: the modeled cost of
        evicting this request — PCIe round trip when its KV is worth
        swapping, quadratic recompute time otherwise. The scheduler
        normalizes by the pages freed toward the current shortfall and
        the cheapest seconds-per-needed-page victim wins."""
        n = len(table.blocks)
        ctx = min(req.prefilled_len, table.num_tokens) + req.n_generated
        if self._swap_worth_it(req, n):
            return 2.0 * self.swap_net.swap_time(
                n, page_bytes=self.kv_page_bytes)
        return self.cost.c_token * ctx + \
            self.cost.c_ctx * self.cost.prefill_read_tokens(0, ctx)

    # -- ServingBackend protocol ----------------------------------------------
    def add_request(self, req: Request) -> None:
        self.scheduler.add_request(req)

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.waiting or self.scheduler.running)

    def clock(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        """Fast-forward across an idle gap (next arrival)."""
        self._now = max(self._now, t)

    def charge_network(self, seconds: float) -> None:
        """Advance the virtual clock by modeled network time (payload copy
        at copy-mode adoption, lease RPC at borrow)."""
        self._now += seconds
        self.net_time += seconds
        if self.trace is not None:
            self.trace.instant("net", "charge", seconds=seconds)

    def step(self, now: Optional[float] = None) -> List[Request]:
        tr = self.trace
        if tr is not None:
            tr.iteration = self.iterations
        plan = self.scheduler.schedule()
        self.preemptions += len(plan.preempted)
        # PCIe traffic this iteration: demand swap-outs, speculative issues
        # (the DMA starts now, regardless of how it later resolves), and
        # swap-ins. Completions/cancels were charged at their issue.
        out_pages = sum(len(p) for _, p in plan.swap_out) + \
            sum(len(p) for _, p in plan.swap_issue)
        in_pages = sum(len(p) for _, p in plan.swap_in)
        t_swap = 0.0
        if out_pages or in_pages:
            t_swap = self.swap_net.swap_time(
                out_pages, page_bytes=self.kv_page_bytes) + \
                self.swap_net.swap_time(in_pages,
                                        page_bytes=self.kv_page_bytes)
            self.swap_time_s += t_swap
        self.swapped_out += len(plan.swap_out) + len(plan.swap_complete)
        self.swapped_in += len(plan.swap_in)
        self.swap_cancels += len(plan.swap_cancel)
        if plan.empty:
            # no compute to hide behind — the PCIe time is fully exposed
            self._now += t_swap
            # nothing computed, but a preemption may still have happened
            # (a lone request outgrowing the whole pool preempts *itself*,
            # leaving an empty plan) — complete_iteration must still run so
            # the max_preemptions drop policy can retire it, else the
            # backend stalls forever with the request bouncing in waiting
            return self.scheduler.complete_iteration(plan, self._now) \
                if plan.preempted else []
        # context reads split local vs remote: a zero-copy lease serves a
        # request's leading r_base tokens from a creditor instance's pages
        # (micro-attention computed where the block lives, partials merged),
        # charged at c_remote instead of c_ctx, plus a per-request merge
        # round when the network model is on
        remote_of = self.scheduler.remote_tokens_of
        sum_ctx = sum_remote = n_borrowing = 0
        for r in plan.decode:
            rb = remote_of(r.request_id)
            sum_ctx += r.context_len - rb
            sum_remote += rb
            n_borrowing += 1 if rb else 0
        # per-chunk cost: chunk tokens read the KV already written by the
        # cached prefix and earlier chunks (see prefill_read_tokens);
        # borrowed prefix tokens are read remotely by every chunk token
        for c in plan.chunks:
            rb = remote_of(c.req.request_id)
            sum_ctx += self.cost.prefill_read_tokens(c.start - rb, c.length)
            sum_remote += c.length * rb
            n_borrowing += 1 if rb else 0
        t_start = self._now
        t_iter = self.cost.iteration_time(plan.token_count(), sum_ctx,
                                          sum_remote)
        # one batched DMA per direction per iteration. Serial (the
        # conservative model): transfers stack on top of compute. Overlap:
        # double-buffered against this iteration's compute, only the
        # surplus past t_iter is exposed on the clock.
        t_exposed = max(0.0, t_swap - t_iter) if self.swap_overlap \
            else t_swap
        self._now += t_iter + t_exposed
        if self.net is not None and n_borrowing:
            t_net = self.net.borrow_iter_overhead(n_borrowing)
            self._now += t_net
            self.net_time += t_net  # network-attributable, like copies
        for c in plan.chunks:  # prefill-in-flight: admission time
            if c.req.scheduled_time is None:
                c.req.scheduled_time = self._now
        # simulate generation: each request whose final chunk or decode ran
        # emits one token (mid-prefill requests emit nothing yet)
        for r in plan.prefill + plan.decode:
            r.output.append(0)
            r.record_token_time(self._now)
            if r.first_token_time is None:
                r.first_token_time = self._now
                if tr is not None:
                    tr.instant("req", "first_token", rid=r.request_id)
            if r.scheduled_time is None:
                r.scheduled_time = self._now
        finished = self.scheduler.complete_iteration(plan, self._now)
        if tr is not None:
            tr.complete("engine", "iteration", ts=t_start,
                        dur=self._now - t_start, tokens=plan.token_count(),
                        decodes=len(plan.decode), chunks=len(plan.chunks),
                        ctx=sum_ctx, remote=sum_remote)
        if self.metrics is not None:
            m = self.metrics
            m.gauge("kv_util_frac",
                    self.allocator.num_used / self.allocator.num_blocks)
            m.gauge("prefill_backlog_tokens",
                    self.scheduler.prefill_backlog_tokens())
            m.gauge("budget_fill_frac",
                    plan.token_count() / self.scheduler.max_tokens)
            m.gauge("running", len(self.scheduler.running))
            m.gauge("waiting", len(self.scheduler.waiting))
            m.gauge("net_time_s", self.net_time)
            if self.allocator.num_host_blocks:
                m.gauge("swapped_pages", self.allocator.swapped_pages)
                m.gauge("swap_time_s", self.swap_time_s)
                m.gauge("swap_pending_pages",
                        self.allocator.pending_out_pages)
            if self.prefix_cache is not None:
                m.gauge("prefix_hit_rate", self.prefix_cache.hit_rate)
            m.count("tokens", plan.token_count())
            m.count("decode_tokens", len(plan.decode))
            m.count("prefill_tokens", sum(c.length for c in plan.chunks))
            m.count("preemptions", len(plan.preempted))
            m.count("swap_outs", len(plan.swap_out) + len(plan.swap_complete))
            m.count("swap_ins", len(plan.swap_in))
            m.count("swap_issues", len(plan.swap_issue))
            m.count("swap_cancels", len(plan.swap_cancel))
            m.snapshot(self._now, self.iterations)
        self.iterations += 1
        self.peak_memory_frac = max(
            self.peak_memory_frac,
            self.allocator.num_used / self.allocator.num_blocks)
        tables = list(self.scheduler.tables.values())
        if tables:
            self._utils.append(self.allocator.utilization(tables))
        return finished

    @property
    def kv_utilization(self) -> float:
        return float(np.mean(self._utils)) if self._utils else 1.0


def simulate_paged(requests: Sequence[Request], *, num_blocks: int = 7000,
                   block_size: int = 16, max_running: int = 256,
                   max_tokens_per_iter: int = 8192,
                   prefix_cache: bool = False,
                   chunk_policy: str = "decode_first",
                   max_preemptions: Optional[int] = None,
                   host_blocks: int = 0,
                   swap_mode: str = "sacrifice",
                   victim_policy: str = "lifo",
                   swap_overlap: bool = False,
                   speculative_swap: bool = False,
                   cost: Optional[CostModel] = None,
                   net: Optional[NetworkModel] = None,
                   trace: bool = False) -> SimResult:
    """Replay ``requests`` through :class:`SimBackend` behind the LLMService
    front-end (one drive loop for engine and simulator alike).

    ``prefix_cache``: attach a radix-tree prefix KV cache — admission
    charges only the uncached prompt suffix (requests need real token ids,
    e.g. from :func:`make_shared_prefix_workload`).
    ``chunk_policy``: chunked-prefill budget policy (``decode_first`` |
    ``prefill_first`` | ``monolithic`` | legacy ``solo``), see
    :class:`~repro_torch.core.scheduling.iteration.IterationScheduler`.
    ``host_blocks`` / ``swap_mode`` / ``victim_policy``: host swap tier —
    preemption victims' KV moves to host pages over a modeled PCIe lane
    (``net.pcie_gbps``) instead of being recomputed; see SWAP_MODES /
    VICTIM_POLICIES in the scheduler module.
    ``swap_overlap``: double-buffer the PCIe DMAs against each iteration's
    compute (only the surplus past the compute time hits the clock).
    ``speculative_swap``: the scheduler issues decode swap-outs *early*
    when free pages trend under the watermark, cancelling if pressure
    recedes before the transfer resolves."""
    from repro_torch.serving.api import LLMService  # late: api imports Request

    backend = SimBackend(num_blocks=num_blocks, block_size=block_size,
                         max_running=max_running,
                         max_tokens_per_iter=max_tokens_per_iter,
                         prefix_cache=prefix_cache,
                         max_preemptions=max_preemptions,
                         host_blocks=host_blocks, swap_mode=swap_mode,
                         victim_policy=victim_policy,
                         swap_overlap=swap_overlap,
                         speculative_swap=speculative_swap,
                         chunk_policy=chunk_policy, cost=cost, net=net,
                         trace=trace)
    svc = LLMService(backend)
    for r in sorted(requests, key=lambda r: r.arrival_time):
        svc.submit_request(r)
    svc.drain()
    res = SimResult(list(requests), makespan=backend.clock(),
                    peak_memory_frac=backend.peak_memory_frac,
                    kv_utilization=backend.kv_utilization,
                    preemptions=backend.preemptions,
                    swapped_out=backend.swapped_out,
                    swapped_in=backend.swapped_in,
                    swap_time=backend.swap_time_s,
                    swap_cancels=backend.swap_cancels)
    if backend.prefix_cache is not None:
        res.prefix_hit_rate = backend.prefix_cache.hit_rate
        res.cached_pages = backend.prefix_cache.num_pages
    if backend.trace is not None:
        res.events = backend.trace.events()
        res.timelines = {0: backend.metrics.rows()}
    return res


def simulate_router(requests: Sequence[Request], *, n_instances: int = 4,
                    policy: str = "round_robin",
                    prefix_cache: bool = True,
                    prefix_share: bool = False,
                    share_mode: str = "copy",
                    hot_threshold: int = 1,
                    board_pages: Optional[int] = None,
                    peer_spill: bool = False,
                    cache_spill_pages: int = 0,
                    blocks_per_instance: int = 1800, block_size: int = 16,
                    max_running: int = 64,
                    max_tokens_per_iter: int = 8192,
                    max_preemptions: Optional[int] = None,
                    chunk_policy: str = "decode_first",
                    cost: Optional[CostModel] = None,
                    net: Optional[NetworkModel] = None,
                    trace: bool = False) -> SimResult:
    """Virtual-clock cluster sim: N :class:`SimBackend` instances behind a
    :class:`~repro_torch.serving.router.RouterBackend`, driven to completion
    through the LLMService front-end. The event-driven router advances the
    laggard instance each step, so policy sweeps over many instances run in
    milliseconds of wall time.

    ``policy``: ``round_robin`` | ``least_loaded`` | ``prefix_affinity``
    (see ``serving.router.POLICIES``). ``prefix_share`` publishes hot radix
    paths through the distkv board so instances reuse each other's cached
    prefixes; ``share_mode`` picks how (``copy`` payload adoption |
    ``zero_copy`` borrowed rBlocks served through the DistAttention merge |
    ``auto`` per-request cost decision). ``net`` attaches the
    :class:`~repro_torch.core.distkv.netmodel.NetworkModel` so copies and
    borrows cost virtual time (required for an honest copy-vs-borrow comparison)."""
    from repro_torch.serving.api import LLMService  # late: api imports Request
    from repro_torch.serving.router import RouterBackend

    children = [SimBackend(num_blocks=blocks_per_instance,
                           block_size=block_size, max_running=max_running,
                           max_tokens_per_iter=max_tokens_per_iter,
                           prefix_cache=prefix_cache,
                           max_preemptions=max_preemptions,
                           cache_spill_pages=cache_spill_pages,
                           chunk_policy=chunk_policy, cost=cost, net=net,
                           trace=trace)
                for _ in range(n_instances)]
    router = RouterBackend(children, policy=policy,
                           prefix_share=prefix_share,
                           share_mode=share_mode,
                           hot_threshold=hot_threshold,
                           board_pages=board_pages, net=net,
                           peer_spill=peer_spill)
    svc = LLMService(router)
    for r in sorted(requests, key=lambda r: r.arrival_time):
        svc.submit_request(r)
    svc.drain()
    # utilization over instances that actually held tables — an idle
    # instance's vacuous 1.0 default would flatter a policy that
    # concentrates load
    utils = [c.kv_utilization for c in children if c._utils]
    res = SimResult(list(requests), makespan=router.clock(),
                    peak_memory_frac=max(c.peak_memory_frac
                                         for c in children),
                    kv_utilization=float(np.mean(utils)) if utils else 1.0,
                    preemptions=router.preemptions,
                    per_instance=router.instance_stats())
    agg = router.prefix_cache
    if agg is not None:
        res.prefix_hit_rate = agg.hit_rate
        res.cached_pages = agg.num_pages
        res.adopted_pages = agg.adopted_pages
    res.borrowed_pages = router.pages_borrowed
    res.net_time = sum(getattr(c, "net_time", 0.0) for c in children)
    if trace:
        res.events = router.trace_events()
        res.timelines = router.metrics_timelines()
    return res


def simulate_disagg(requests: Sequence[Request], *, roles: str = "2p2d",
                    handoff_mode: str = "auto",
                    handoff_defer_cap: int = 8,
                    policy: str = "least_loaded",
                    prefix_cache: bool = True,
                    blocks_per_instance: int = 1800, block_size: int = 16,
                    max_running: int = 64,
                    max_tokens_per_iter: int = 8192,
                    max_preemptions: Optional[int] = None,
                    chunk_policy: str = "decode_first",
                    cost: Optional[CostModel] = None,
                    net: Optional[NetworkModel] = None,
                    trace: bool = False) -> SimResult:
    """Disaggregated prefill/decode cluster sim: role-tagged
    :class:`SimBackend` instances behind the router's
    :class:`~repro_torch.serving.disagg.KVHandoff` coordinator.

    ``roles`` is a ``parse_role_spec`` string (``"2p2d"`` = 2 prefill + 2
    decode instances) or role-name list; the instance count comes from it.
    New prompts land only on prefill-capable instances, finished prompt KV
    moves to a decode instance per ``handoff_mode`` (``migrate`` |
    ``zero_copy`` | ``auto``), and ``net`` (defaulted by the router when
    omitted) charges the transfer against the virtual clocks — the frontier
    against mixed-instance chunked prefill is only honest with the handoff
    cost on the books. Decode instances run pure decode iterations, which
    is the P99-TBT story ``benchmarks/disagg_sweep.py`` measures."""
    from repro_torch.serving.api import LLMService  # late: api imports Request
    from repro_torch.serving.disagg import parse_role_spec
    from repro_torch.serving.router import RouterBackend

    role_list = parse_role_spec(roles)
    children = [SimBackend(num_blocks=blocks_per_instance,
                           block_size=block_size, max_running=max_running,
                           max_tokens_per_iter=max_tokens_per_iter,
                           prefix_cache=prefix_cache,
                           max_preemptions=max_preemptions,
                           chunk_policy=chunk_policy, cost=cost, net=net,
                           trace=trace)
                for _ in role_list]
    router = RouterBackend(children, policy=policy, roles=role_list,
                           handoff_mode=handoff_mode,
                           handoff_defer_cap=handoff_defer_cap, net=net)
    svc = LLMService(router)
    for r in sorted(requests, key=lambda r: r.arrival_time):
        svc.submit_request(r)
    svc.drain()
    utils = [c.kv_utilization for c in children if c._utils]
    res = SimResult(list(requests), makespan=router.clock(),
                    peak_memory_frac=max(c.peak_memory_frac
                                         for c in children),
                    kv_utilization=float(np.mean(utils)) if utils else 1.0,
                    preemptions=router.preemptions,
                    per_instance=router.instance_stats())
    agg = router.prefix_cache
    if agg is not None:
        res.prefix_hit_rate = agg.hit_rate
        res.cached_pages = agg.num_pages
        res.adopted_pages = agg.adopted_pages
    res.borrowed_pages = router.pages_borrowed
    res.net_time = sum(getattr(c, "net_time", 0.0) for c in children)
    res.handoffs_migrated = router.handoff.handoffs_migrated
    res.handoffs_leased = router.handoff.handoffs_leased
    res.handoff_deferrals = router.handoff.deferrals
    res.handoff_fallbacks = router.handoff.fallbacks
    if trace:
        res.events = router.trace_events()
        res.timelines = router.metrics_timelines()
        res.role_timelines = router.role_timelines()
    return res


def simulate_prealloc(requests: Sequence[Request], *, total_slots: int,
                      max_len: int = 2048, policy: str = "max",
                      max_running: int = 256,
                      max_tokens_per_iter: int = 8192,
                      cost: Optional[CostModel] = None) -> SimResult:
    """Orca (Max/Pow2/Oracle): iteration-level scheduling with contiguous
    per-request reservations instead of paging."""
    cost = cost or CostModel()
    res = ContiguousPreallocAllocator(total_slots, max_len, policy)
    pending = sorted(requests, key=lambda r: r.arrival_time)
    waiting: List[Request] = []
    running: List[Request] = []
    now, i_pending = 0.0, 0
    utils = []
    n_left = len(pending)
    while n_left > 0:
        while i_pending < len(pending) and \
                pending[i_pending].arrival_time <= now:
            waiting.append(pending[i_pending])
            i_pending += 1
        # admit FCFS while reservations fit
        prefill: List[Request] = []
        budget = max_tokens_per_iter - len(running)
        while waiting and len(running) + len(prefill) < max_running:
            req = waiting[0]
            total = req.prompt_len + req.max_new_tokens
            if req.prompt_len > budget or not res.can_admit(total):
                break
            waiting.pop(0)
            res.admit(req.request_id, total)
            res.store(req.request_id, req.prompt_len)
            budget -= req.prompt_len
            prefill.append(req)
        decode = list(running)
        if not prefill and not decode:
            if i_pending < len(pending):
                now = max(now, pending[i_pending].arrival_time)
                continue
            break
        n_tok = sum(r.prompt_len for r in prefill) + len(decode)
        sum_ctx = sum(r.context_len for r in decode) + \
            sum(cost.prefill_read_tokens(0, r.prompt_len) for r in prefill)
        now += cost.iteration_time(n_tok, sum_ctx)
        for r in prefill + decode:
            r.output.append(0)
            res.store(r.request_id, 1)
            if r.first_token_time is None:
                r.first_token_time = now
        running.extend(prefill)
        for r in list(running):
            if r.done:
                r.phase = Phase.FINISHED
                r.finish_time = now
                res.release(r.request_id)
                running.remove(r)
                n_left -= 1
        utils.append(res.utilization())
    return SimResult(list(requests), makespan=now,
                     kv_utilization=float(np.mean(utils)) if utils else 1.0)


def simulate_batch_level(requests: Sequence[Request], *, max_batch: int = 32,
                         cost: Optional[CostModel] = None) -> SimResult:
    """Pre-ORCA batch-level scheduling: the whole batch runs until its
    longest member finishes (early-finish waste + queueing delay)."""
    cost = cost or CostModel()
    sched = BatchScheduler(max_batch=max_batch)
    pending = sorted(requests, key=lambda r: r.arrival_time)
    now, i_pending = 0.0, 0
    n_left = len(pending)
    while n_left > 0:
        while i_pending < len(pending) and \
                pending[i_pending].arrival_time <= now:
            sched.add_request(pending[i_pending])
            i_pending += 1
        plan = sched.schedule()
        if plan.empty:
            if i_pending < len(pending):
                now = max(now, pending[i_pending].arrival_time)
                continue
            break
        batch = plan.batch
        n_iters = max(r.max_new_tokens for r in batch)
        # prefill iteration
        now += cost.iteration_time(
            sum(r.prompt_len for r in batch),
            sum(cost.prefill_read_tokens(0, r.prompt_len) for r in batch))
        for it in range(n_iters):
            live_ctx = sum(min(r.context_len + 1, r.prompt_len +
                               r.max_new_tokens) for r in batch)
            now += cost.iteration_time(len(batch), live_ctx)
            for r in batch:
                if r.n_generated < r.max_new_tokens:
                    r.output.append(0)
                    if r.first_token_time is None:
                        r.first_token_time = now
        n_left -= len(sched.complete_batch(now))
    return SimResult(list(requests), makespan=now)


# ---------------------------------------------------------------------------
# DistKV-LLM multi-instance simulation (Fig. 10)
# ---------------------------------------------------------------------------

class _LocalKV:
    """Instance-local paged KV backend (vanilla vLLM instance)."""

    def __init__(self, alloc: BlockAllocator):
        self.alloc = alloc
        self.counts: Dict[int, int] = {}  # req -> tokens stored
        self.blocks: Dict[int, List[int]] = {}

    def grow(self, rid: int, n: int) -> bool:
        cur = self.counts.get(rid, 0)
        bs = self.alloc.block_size
        need = -(-(cur + n) // bs) - len(self.blocks.get(rid, []))
        if need > self.alloc.num_free:
            return False
        owned = self.blocks.setdefault(rid, [])
        for _ in range(need):
            owned.append(self.alloc.alloc_block())
        self.counts[rid] = cur + n
        return True

    def free(self, rid: int) -> None:
        self.counts.pop(rid, None)
        for b in self.blocks.pop(rid, []):
            self.alloc.decref(b)

    def remote_fraction(self, rid: int) -> float:
        return 0.0


class _DistKV:
    """DistKV-LLM backend: local first, then borrow via gManager."""

    def __init__(self, rm: RManager):
        self.rm = rm

    def grow(self, rid: int, n: int) -> bool:
        try:
            self.rm.append_tokens(rid, n)
            return True
        except OutOfBlocks:
            return False

    def free(self, rid: int) -> None:
        self.rm.free_seq(rid)

    def remote_fraction(self, rid: int) -> float:
        return self.rm.remote_fraction(rid)


def simulate_distkv(requests: Sequence[Request], *, n_instances: int = 4,
                    blocks_per_instance: int = 1800, block_size: int = 16,
                    max_running: int = 64, max_tokens_per_iter: int = 8192,
                    borrow: bool = True,
                    cost: Optional[CostModel] = None) -> SimResult:
    """Round-robin requests over instances. With ``borrow`` (DistKV-LLM) an
    exhausted instance borrows rBlocks via the gManager debt ledger; remote
    context incurs ``c_remote``. Without it (vanilla paged instances) a
    request that cannot grow is preempted (recompute) — the paper's baseline.
    Instances run in lockstep epochs of the slowest instance's iteration."""
    cost = cost or CostModel()
    g = GManager(n_instances)
    backends: Dict[int, object] = {}
    if borrow:
        rms = {i: RManager(i, BlockAllocator(blocks_per_instance, block_size),
                           g) for i in range(n_instances)}
        for r in rms.values():
            r.register_peers(rms)
        backends = {i: _DistKV(rms[i]) for i in range(n_instances)}
    else:
        backends = {i: _LocalKV(BlockAllocator(blocks_per_instance,
                                               block_size))
                    for i in range(n_instances)}

    waiting: Dict[int, List[Request]] = {i: [] for i in range(n_instances)}
    running: Dict[int, List[Request]] = {i: [] for i in range(n_instances)}
    pending = sorted(requests, key=lambda r: r.arrival_time)
    preemptions = 0
    rejected = 0
    # capacity guard: a request whose *total* context can never fit is
    # rejected up front (local capacity without borrowing; cluster capacity
    # with) — the baseline's fundamental long-context limitation.
    cap_tokens = blocks_per_instance * block_size
    if borrow:
        cap_tokens *= n_instances

    now, i_pending, n_left = 0.0, 0, len(pending)
    while n_left > 0:
        while i_pending < len(pending) and \
                pending[i_pending].arrival_time <= now:
            r = pending[i_pending]
            if r.prompt_len + r.max_new_tokens > cap_tokens * 0.9:
                rejected += 1
                n_left -= 1
            else:
                waiting[i_pending % n_instances].append(r)
            i_pending += 1
        t_instances = [0.0]
        for inst in range(n_instances):
            kv = backends[inst]
            budget = max_tokens_per_iter
            decode: List[Request] = []
            prefill: List[Request] = []
            # decode growth (borrow or preempt)
            for req in list(running[inst]):
                if budget <= 0:
                    break
                if kv.grow(req.request_id, 1):
                    decode.append(req)
                    budget -= 1
                else:
                    kv.free(req.request_id)
                    req.committed_output.extend(req.output)
                    req.prompt_len = req.context_len
                    req.max_new_tokens -= req.n_generated
                    req.output = []
                    req.preemptions += 1
                    preemptions += 1
                    running[inst].remove(req)
                    waiting[inst].insert(0, req)
            # admission (a prompt larger than the whole token budget may run
            # alone when the instance is otherwise idle — chunked-prefill
            # stand-in, else huge prompts head-of-line-block forever)
            while waiting[inst] and len(running[inst]) + len(prefill) \
                    < max_running:
                req = waiting[inst][0]
                solo_ok = (not decode and not prefill)
                if (req.prompt_len > budget and not solo_ok) or \
                        not kv.grow(req.request_id, req.prompt_len):
                    break
                waiting[inst].pop(0)
                prefill.append(req)
                budget -= req.prompt_len
            if not decode and not prefill:
                continue
            sum_ctx = sum(r.context_len for r in decode) + \
                sum(cost.prefill_read_tokens(0, r.prompt_len)
                    for r in prefill)
            remote_ctx = sum(int(r.context_len *
                                 kv.remote_fraction(r.request_id))
                             for r in decode)
            n_tok = sum(r.prompt_len for r in prefill) + len(decode)
            t = cost.iteration_time(n_tok, sum_ctx, remote_ctx)
            t_instances.append(t)
            running[inst].extend(prefill)
            for r in prefill + decode:
                r.output.append(0)
                if r.first_token_time is None:
                    r.first_token_time = now + t
            for r in list(running[inst]):
                if r.done:
                    r.phase = Phase.FINISHED
                    r.finish_time = now + t
                    kv.free(r.request_id)
                    running[inst].remove(r)
                    n_left -= 1
        step = max(t_instances)
        if step == 0.0:
            if i_pending < len(pending):
                now = max(now, pending[i_pending].arrival_time)
                continue
            break
        now += step
    return SimResult(list(requests), makespan=now, preemptions=preemptions,
                     rejected=rejected)
