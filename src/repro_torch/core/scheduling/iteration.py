"""ORCA iteration-level scheduler (paper §III.B Sol1) with selective batching
and Sarathi-style chunked prefill.

Each call to :meth:`schedule` plans exactly ONE engine iteration as a single
**token-budget batch composition**: ongoing decodes, prefill *chunks* of
running requests, and new admissions all draw from one
``max_tokens_per_iter`` budget. Early-finished requests leave the batch
immediately; late-joining requests enter at the next iteration — the exact
fix for ORCA's challenge C1.

Chunked prefill. A prompt larger than the iteration budget used to run
*solo* (stalling every running decode for the whole prefill). Now a request
is admitted once and then contributes budget-sized **chunks** across
successive iterations, tracked by ``Request.prefilled_len``: each iteration
the request prefills ``min(remaining prompt, leftover budget)`` tokens,
piggybacked with the ongoing decodes, and only the final chunk samples a
token. ``chunk_policy`` picks who gets the budget first:

* ``decode_first`` (default, Sarathi-style stall-free batching) — every
  running decode is granted its token before any prefill work, so TBT stays
  bounded by one budget-sized iteration;
* ``prefill_first`` — chunk continuations and admissions take the budget
  first and decodes run in the leftover (TTFT-optimal, decodes may stall
  under sustained prefill pressure — the classic prefill-priority trade);
* ``monolithic`` — no chunking: an over-budget prompt is admitted alongside
  the running decodes and prefills in ONE iteration, stalling every decode
  for the full prefill (the vLLM-default "solo prefill in the batch"
  baseline the chunked benchmark measures against);
* ``solo`` — the legacy stand-in policy: an over-budget prompt waits for an
  otherwise-idle instance and then runs alone. Decodes never stall (none
  are running), but the waiting prompt head-of-line-blocks every admission
  behind it while decodes drain — the TTFT/throughput pathology.

Selective batching (Sol2) shows up as the *token budget*: attention is
per-sequence (paged cache), while MLP/linear layers run over the flattened
token buffer, so the scheduler bounds ``sum(chunk lens) + #decodes`` per
iteration rather than the sequence count.

Memory is delegated to a :class:`BlockAllocator` (vLLM §III.C) or any object
with the same interface; a request's whole prompt worth of pages is reserved
at admission (chunk continuations never allocate). When pages run out a
victim chosen by ``victim_policy`` (LIFO / FIFO / LRU) loses its device
pages — by **sacrifice** (vLLM's recompute policy: pages freed, though the
victim's computed prompt pages are first adopted into the radix tree so the
recompute covers only the uncached suffix) or, with a host tier configured
and ``swap_mode`` allowing it, by **swap-to-host**: the KV moves to host
pages over PCIe, the request re-enters WAITING still holding its (now
host-resident) table, and swap-in resumes decode or mid-prefill chunking
exactly where it stopped — no recompute at all. ``swap_mode="auto"``
decides per victim via ``swap_decider`` (the sim wires a PCIe-vs-recompute
cost comparison) or a computed-token threshold.

With a :class:`~repro_torch.core.prefixcache.PrefixCache` attached, admission first
matches the prompt against the radix tree: matched pages are locked into the
request's block table (refcounted, no recompute) and only the *uncached
suffix* is charged against the token budget — chunked exactly like a cold
prompt when it exceeds the budget. With ``token_level`` matching the hit may
end mid-page: the partially-matched node is locked with only the shared run
counted as stored, and the allocator's copy-on-write duplicates the boundary
page on the first suffix write (the SGLang split realized as a partial-page
COW). Prompt pages are inserted into the tree as soon as prefill completes
(and survive the request), and under page pressure LRU cache eviction runs
before any preemption.

``prefix_importer`` extends the match across instances: before committing
to a local match, admission offers the prompt to the importer (wired by a
cluster router to the distkv publication board), which may *adopt* pages a
peer instance published into the local tree — the admission then re-matches
and prefills only the suffix past the imported prefix.

``remote_adopter`` is the zero-copy alternative: instead of copying
payloads, it may return a :class:`~repro_torch.core.distkv.rmanager.RemoteLease`
— borrowed rBlocks whose pages stay on the creditor instance. The request
is then admitted with only its *suffix* pages local (positions
``[0, lease.num_tokens)`` are served remotely through the DistAttention
partial merge), the lease is held for the request's lifetime, and release
(finish or preemption) repays the creditor **before** any local page is
freed. Leased prompts are never inserted into the local radix tree — their
leading pages do not exist here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.paging.allocator import BlockAllocator, BlockTable
from repro_torch.core.prefixcache.radix import PrefixCache
from repro_torch.core.scheduling.request import Phase, Request

CHUNK_POLICIES = ("decode_first", "prefill_first", "monolithic", "solo")
# what happens to a preemption victim's KV:
#   sacrifice — free the pages, recompute on re-admission (the vLLM default)
#   swap      — move the pages to the host tier over PCIe, resume without
#               re-prefilling (falls back to sacrifice when host is full)
#   auto      — per-victim decision: swap when the modeled transfer undercuts
#               the recompute (``swap_decider``), else a computed-token
#               threshold stand-in
SWAP_MODES = ("sacrifice", "swap", "auto")
# who gets preempted when pages run out:
#   lifo — youngest running request (least sunk work, the vLLM default)
#   fifo — oldest running request
#   lru  — least recently *scheduled* (no decode/chunk granted longest)
#   cost — cheapest to evict per freed page: rank candidates by modeled
#          eviction seconds (PCIe round trip if the victim would swap,
#          quadratic recompute if it would sacrifice) divided by the pages
#          freed (``victim_cost_fn``, or a built-in mirror of the sim's
#          cost-model constants)
VICTIM_POLICIES = ("lifo", "fifo", "lru", "cost")


@dataclasses.dataclass
class PrefillChunk:
    """One iteration's slice of a request's prefill: compute prompt tokens
    ``[start, start + length)`` at their absolute positions. ``start`` of the
    first chunk is the cached-prefix length (which may be mid-page under
    token-level matching)."""
    req: Request
    start: int
    length: int

    @property
    def end(self) -> int:
        return self.start + self.length

    @property
    def is_last(self) -> bool:
        return self.end == self.req.prompt_len


@dataclasses.dataclass
class IterationPlan:
    # requests whose FINAL prefill chunk runs this iteration: they produce
    # first-token logits and enter decode next iteration. (Backends append
    # COW-forked best-of-n children here after scheduling.)
    prefill: List[Request]
    decode: List[Request]
    preempted: List[Request]
    # copy-on-write block replacements this iteration: the engine must copy
    # each old physical page into its new page before any decode write
    cow: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # ALL prefill work this iteration (including the final chunks mirrored
    # in ``prefill``): the execution backends run these in order
    chunks: List[PrefillChunk] = dataclasses.field(default_factory=list)
    # host-tier transfers this iteration, as (request, page-pair list):
    # swap_out pairs are (device, host), swap_in pairs are (host, device).
    # The page payloads were already moved by the scheduler's swap hooks
    # (engine) — these lists exist for backends to charge transfer time
    # (sim PCIe lane) and manage per-request state (engine decode slots).
    swap_out: List[Tuple[Request, List[Tuple[int, int]]]] = \
        dataclasses.field(default_factory=list)
    swap_in: List[Tuple[Request, List[Tuple[int, int]]]] = \
        dataclasses.field(default_factory=list)
    # overlapped (speculative) swap-out lifecycle, same (request, pairs)
    # shape: ``swap_issue`` starts a device->host copy that double-buffers
    # against the NEXT iteration's compute, ``swap_complete`` lands it one
    # iteration later (device pages free only now), ``swap_cancel`` aborts
    # it because pressure receded (pages never left). Backends use these to
    # move the payloads (engine) / charge overlap-windowed PCIe time (sim)
    # and to manage per-request decode slots.
    swap_issue: List[Tuple[Request, List[Tuple[int, int]]]] = \
        dataclasses.field(default_factory=list)
    swap_complete: List[Tuple[Request, List[Tuple[int, int]]]] = \
        dataclasses.field(default_factory=list)
    swap_cancel: List[Tuple[Request, List[Tuple[int, int]]]] = \
        dataclasses.field(default_factory=list)

    @property
    def empty(self) -> bool:
        """No *compute* this iteration. Swap-only iterations are still
        "empty" — backends must process ``swap_out``/``swap_in`` (and
        ``swap_issue``/``swap_complete``/``swap_cancel``/``preempted``)
        before early-returning on this."""
        return not (self.chunks or self.prefill or self.decode)

    def token_count(self) -> int:
        """Tokens through the flattened MLP buffer this iteration (cached
        prefix pages are read, not recomputed — they cost no prefill FLOPs)."""
        return sum(c.length for c in self.chunks) + len(self.decode)


class IterationScheduler:
    def __init__(self, allocator: BlockAllocator, *,
                 max_running: int = 64,
                 max_tokens_per_iter: int = 8192,
                 watermark: float = 0.01,
                 prefix_cache: Optional[PrefixCache] = None,
                 max_preemptions: Optional[int] = None,
                 cache_generated: bool = True,
                 chunk_policy: str = "decode_first",
                 decode_reserve: bool = True,
                 prefill_chunk_min: Optional[int] = None,
                 prefix_importer: Optional[
                     Callable[[Sequence[int], int], int]] = None,
                 remote_adopter: Optional[
                     Callable[[Request, int], Optional[object]]] = None,
                 prefill_only: bool = False,
                 swap_mode: str = "sacrifice",
                 victim_policy: str = "lifo",
                 swap_decider: Optional[
                     Callable[[Request, int], bool]] = None,
                 swap_min_tokens: Optional[int] = None,
                 victim_cost_fn: Optional[
                     Callable[[Request, BlockTable], float]] = None,
                 speculative_swap: bool = False):
        if chunk_policy not in CHUNK_POLICIES:
            raise ValueError(f"chunk_policy must be one of {CHUNK_POLICIES}, "
                             f"got {chunk_policy!r}")
        if swap_mode not in SWAP_MODES:
            raise ValueError(f"swap_mode must be one of {SWAP_MODES}, "
                             f"got {swap_mode!r}")
        if victim_policy not in VICTIM_POLICIES:
            raise ValueError(f"victim_policy must be one of "
                             f"{VICTIM_POLICIES}, got {victim_policy!r}")
        self.allocator = allocator
        self.max_running = max_running
        self.max_tokens = max_tokens_per_iter
        self.watermark_blocks = max(1, int(allocator.num_blocks * watermark))
        self.prefix_cache = prefix_cache
        # a request preempted more than this many times is dropped with
        # finish_reason "preempted-dropped" instead of recomputed forever
        self.max_preemptions = max_preemptions
        # insert *generated* tokens into the radix tree at finish, so a
        # multi-turn follow-up resending the assistant reply hits the cache
        # beyond the prompt. Disable when outputs are placeholder ids (sim).
        self.cache_generated = cache_generated
        self.chunk_policy = chunk_policy
        # prefill_first only: set aside the pages this iteration's decode
        # grants will need BEFORE admissions run (admission-before-decode
        # could otherwise admit a request the same iteration's decode growth
        # then preempts). False restores the old racy behavior (tests).
        self.decode_reserve = decode_reserve
        # smallest first chunk worth ADMITTING a request on (degenerate
        # slivers pay an iteration's fixed cost for a handful of tokens,
        # and admitting on a sliver starts a prefill before a same-prefix
        # predecessor could warm the radix tree). Continuations are exempt:
        # an admitted request holds pages, so it always progresses. A final
        # chunk smaller than this still runs — prompts end somewhere.
        self.prefill_chunk_min = prefill_chunk_min \
            if prefill_chunk_min is not None else allocator.block_size
        # cross-instance sharing hook: (prompt, locally_cached_tokens) ->
        # #pages adopted from a peer's publication into the local tree.
        # Admission re-matches after a successful import.
        self.prefix_importer = prefix_importer
        # zero-copy sharing hook: (request, locally_cached_tokens) -> a
        # RemoteLease of borrowed rBlocks strictly longer than the local
        # match, or None. Tried BEFORE the copy importer; when a lease is
        # granted the copy path is skipped for this admission.
        self.remote_adopter = remote_adopter
        # disaggregated serving: a prefill-role instance never plans decode
        # tokens — a request whose prefill completed parks in ``running``
        # (Phase.INCREMENT) until a KVHandoff coordinator moves its KV to a
        # decode instance via release_request()/install_running()
        self.prefill_only = prefill_only
        # swap-to-host preemption (see SWAP_MODES / VICTIM_POLICIES above).
        # ``swap_decider(req, n_pages) -> bool`` resolves "auto" per victim
        # (the sim wires a PCIe-vs-recompute cost comparison); without one,
        # auto swaps once the victim's computed context reaches
        # ``swap_min_tokens`` (default: 8 pages' worth — below that the
        # recompute is cheaper than the round trip).
        self.swap_mode = swap_mode
        self.victim_policy = victim_policy
        self.swap_decider = swap_decider
        self.swap_min_tokens = swap_min_tokens if swap_min_tokens is not None \
            else 8 * allocator.block_size
        # cost victim policy: (request, table) -> the raw eviction bill in
        # seconds (PCIe round trip if the victim would swap, quadratic
        # recompute if it would sacrifice). _pick_from normalizes by the
        # pages the eviction actually frees toward the current shortfall,
        # lower = better victim. The sim wires its CostModel/NetworkModel;
        # without one a built-in mirror of those constants runs
        # (see _victim_cost).
        self.victim_cost_fn = victim_cost_fn
        # speculative overlapped swap-out: when free pages trend under the
        # watermark plus the running decodes' imminent page growth, issue a
        # victim's device->host copy at the END of schedule() so it
        # double-buffers against the next iteration's compute. The
        # allocator's pending ledger keeps the DMA-source pages allocated
        # until the copy completes at the top of the NEXT schedule() — or
        # the issue is cancelled there if pressure receded (pages never
        # left, the victim resumes with zero loss).
        self.speculative_swap = speculative_swap
        self._pending_swaps: List[Tuple[int, Request,
                                        List[Tuple[int, int]]]] = []
        # rids whose speculative swap-out completed: held out of swap-in
        # readmission until pressure genuinely recedes (avail covers their
        # need PLUS a watermark of slack). Without this the completed
        # swap's freed pages readmit the very victim they came from one
        # iteration later — a pure PCIe round trip that frees nothing —
        # because the complete lands before any decode has consumed the
        # pages (the demand path's eviction happens mid-decode-planning,
        # so its freed pages never look quite big enough to readmit into).
        self._swap_hold: set = set()
        # data-movement hooks wired by the engine (None in the sim): called
        # synchronously with the allocator's page pairs, swap_out_hook BEFORE
        # any later work this schedule() could reallocate-and-write the freed
        # device pages, swap_in_hook right after fresh device pages are
        # allocated (nothing reads them until the backend's next compute)
        self.swap_out_hook: Optional[
            Callable[[List[Tuple[int, int]]], None]] = None
        self.swap_in_hook: Optional[
            Callable[[List[Tuple[int, int]]], None]] = None
        # overlapped-swap lifecycle hooks (engine: issue records the pending
        # copy, complete performs it — the ledger guarantees the source
        # pages are still intact one iteration later — cancel drops it)
        self.swap_issue_hook: Optional[
            Callable[[List[Tuple[int, int]]], None]] = None
        self.swap_complete_hook: Optional[
            Callable[[List[Tuple[int, int]]], None]] = None
        self.swap_cancel_hook: Optional[
            Callable[[List[Tuple[int, int]]], None]] = None
        # KVHandoff fallback (disaggregated serving): request ids a
        # prefill-only instance IS allowed to decode — requests whose
        # handoff deferral cap expired decode here, mixed-style, instead of
        # starving behind busy decode instances
        self.decode_exempt: set = set()
        # monotonically increasing schedule() call index — stamps
        # Request.last_planned_iter, the "lru" victim policy's recency key
        self._iter_idx = 0
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.tables: Dict[int, BlockTable] = {}
        self._cache_paths: Dict[int, list] = {}  # request id -> locked nodes
        # outstanding zero-copy prefix leases by request id (shared by
        # COW-forked siblings via lease.acquire)
        self.leases: Dict[int, object] = {}
        # prefill_first decode-page reserve (see schedule())
        self._decode_reserve = 0
        # telemetry: a repro_torch.core.telemetry.Tracer wired by the execution
        # backend, or None (the default — every emission site guards on
        # this so the disabled path allocates nothing)
        self.trace = None

    # -- client API -------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        req.phase = Phase.WAITING
        self.waiting.append(req)
        tr = self.trace
        if tr is not None:
            tr.begin("request", "req", req.request_id,
                     prompt_len=req.prompt_len,
                     max_new_tokens=req.max_new_tokens)

    def finish(self, req: Request, now: float,
               reason: Optional[str] = None) -> None:
        req.phase = Phase.FINISHED
        req.finish_time = now
        req.finish_reason = reason or req.finish_reason_if_done \
            or req.finish_reason
        # repay the creditor of a zero-copy prefix lease FIRST: the debt
        # side must be settled before any local teardown can fault, so a
        # creditor never leaks a lent block
        lease = self.leases.pop(req.request_id, None)
        tr = self.trace
        if lease is not None:
            lease.release()
            if tr is not None:
                tr.instant("lease", "release", rid=req.request_id, ts=now,
                           tokens=lease.num_tokens, cause="finish")
        if tr is not None:
            tr.end("request", "req", req.request_id, ts=now,
                   reason=req.finish_reason, generated=req.n_generated)
        if req.request_id in self.tables:
            table = self.tables[req.request_id]
            # adopt the *generated* tokens' full pages too (the prompt pages
            # were inserted at prefill completion): a multi-turn follow-up
            # that resends this reply as history then hits past the prompt.
            # KV exists for the first num_tokens context tokens — the final
            # sampled token was never fed back, so its page may be partial.
            # A leased request's local pages cover only its suffix (the
            # leading positions live on the creditor), so there is no valid
            # root path to insert. A host-resident (swapped-out) table has
            # no device pages to adopt — finished-while-swapped just frees.
            if self.prefix_cache is not None and self.cache_generated \
                    and len(req.prompt) == req.prompt_len and lease is None \
                    and not table.on_host:
                toks = (req.prompt + req.output)[:table.num_tokens]
                self.prefix_cache.insert(toks, table.blocks)
            # the tree's increfs keep adopted pages alive past free_table
            self._release_cache_path(req)
            self.allocator.free_table(self.tables.pop(req.request_id))
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:  # finished-while-swapped / external cancel
            self.waiting.remove(req)
        self.decode_exempt.discard(req.request_id)

    def _release_cache_path(self, req: Request) -> None:
        path = self._cache_paths.pop(req.request_id, None)
        if path:
            self.prefix_cache.release(path)

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens not yet prefilled: queued prompts plus the unfilled
        remainder of running chunked prefills. A cluster router counts this
        as load — an instance chewing through a 100k-token prompt is busier
        than its request count suggests."""
        backlog = sum(r.prompt_len for r in self.waiting)
        backlog += sum(r.prompt_len - r.prefilled_len for r in self.running
                       if r.prefilled_len < r.prompt_len)
        return backlog

    def remote_tokens_of(self, request_id: int) -> int:
        """Leading context tokens served from a creditor instance's pages
        under a zero-copy lease (0 = fully local). Execution backends use
        this to split attention into local + remote partials."""
        lease = self.leases.get(request_id)
        return lease.num_tokens if lease is not None else 0

    # -- one iteration ------------------------------------------------------------
    def schedule(self) -> IterationPlan:
        plan = IterationPlan(prefill=[], decode=[], preempted=[], cow=[],
                             chunks=[])
        self._budget = self.max_tokens
        self._iter_idx += 1
        if self._pending_swaps:
            # every in-flight swap-out resolves exactly one iteration after
            # issue (double-buffering, not an unbounded queue): complete it
            # — the overlapped copy landed during last iteration's compute —
            # or cancel it if pressure receded meanwhile
            self._resolve_pending_swaps(plan)
        if self.chunk_policy == "prefill_first":
            # decode-page reserve: admissions run BEFORE the decode planner
            # here, so without a reserve an admission can take the very page
            # a running decode needs this same iteration — the decode then
            # preempts someone (possibly the fresh admission) it just made
            # room for. Set aside the pages this iteration's decode grants
            # will allocate before admitting anyone. (Conservative: a decode
            # later denied by the token budget still reserved its page.)
            self._decode_reserve = sum(
                self.allocator.blocks_needed(self.tables[r.request_id], 1)
                for r in self.running
                if r.request_id in self.tables
                and r.prefilled_len >= r.prompt_len) \
                if self.decode_reserve and not self.prefill_only else 0
            self._plan_continuations(plan)
            self._plan_admissions(plan)
            self._decode_reserve = 0
            self._plan_decodes(plan)
        else:  # decode_first (Sarathi stall-free) and legacy solo
            self._plan_decodes(plan)
            self._plan_continuations(plan)
            self._plan_admissions(plan)
        if self.speculative_swap:
            self._maybe_speculate(plan)
        return plan

    # -- overlapped (speculative) swap-out ------------------------------------
    def _growth_pages(self, horizon: int = 2) -> int:
        """Device pages the running decodes will allocate within the next
        ``horizon`` tokens — the demand side of the speculation trigger."""
        total = 0
        for r in self.running:
            t = self.tables.get(r.request_id)
            if t is None or t.on_host:
                continue
            if r.prefilled_len >= r.prompt_len:
                total += self.allocator.blocks_needed(t, horizon)
        return total

    def _maybe_speculate(self, plan: IterationPlan) -> None:
        """Issue one victim's swap-out BEFORE memory actually runs out, so
        the PCIe copy rides under the next iteration's compute instead of
        serializing with it when the demand eviction finally fires."""
        if self.swap_mode == "sacrifice" or self.prefill_only \
                or self.allocator.num_host_blocks == 0 \
                or self._pending_swaps:
            return
        # fire only when the pool cannot serve the running decodes' growth
        # over the lookahead horizon — the same exhaustion signal the
        # demand path's can_append failure gives, just 1-2 iterations
        # earlier. No watermark term: decode appends draw the pool below
        # the watermark freely (only admissions respect it), and firing at
        # the watermark would evict victims a completion was about to save.
        if self.allocator.num_free >= self._growth_pages():
            return  # free pages cover the imminent decode growth
        # decode-phase victims only: they hold a generated token the engine
        # can re-seed its slot from on cancel, and their planned work this
        # iteration is at most one decode token to rescind
        cands = [r for r in self.running
                 if r.request_id in self.tables
                 and r.prefilled_len >= r.prompt_len and r.n_generated > 0
                 and self._should_swap(r)]
        if not cands:
            return
        victim = self._pick_from(cands, needed=max(1, self._growth_pages()))
        self._rescind(plan, victim)
        self._release_cache_path(victim)
        table = self.tables[victim.request_id]
        ticket, pairs = self.allocator.swap_out_issue(table)
        if self.swap_issue_hook is not None:
            self.swap_issue_hook(pairs)
        victim.swaps += 1
        victim.phase = Phase.WAITING
        self.running.remove(victim)
        self.waiting.insert(0, victim)
        plan.swap_issue.append((victim, pairs))
        self._pending_swaps.append((ticket, victim, pairs))
        tr = self.trace
        if tr is not None:
            tr.begin("swap", "pending", victim.request_id,
                     pages=len(pairs), speculative=True)
            tr.instant("sched", "swap_issue", rid=victim.request_id,
                       pages=len(pairs), kind="speculative")

    def _resolve_pending_swaps(self, plan: IterationPlan) -> None:
        """Complete or cancel every in-flight swap-out (issued last
        iteration). Complete: the copy landed during the overlapped compute;
        the ledger's device references drop and the victim stays parked as a
        normal host-resident waiter. Cancel: a finish/eviction freed enough
        pages meanwhile — the device references move back onto the table
        and the victim resumes decode immediately, having lost nothing."""
        pending, self._pending_swaps = self._pending_swaps, []
        tr = self.trace
        for ticket, req, pairs in pending:
            if req.request_id not in self.tables:
                # finished-while-pending / external cancel: free_table
                # already released the host pages; just drop the ledger's
                # device references (no copy — there is nowhere to copy to)
                self.allocator.swap_out_complete(ticket)
                if tr is not None:
                    tr.end("swap", "pending", req.request_id,
                           outcome="orphaned")
                continue
            table = self.tables[req.request_id]
            # hysteresis: cancelling needs a watermark of slack past the
            # growth that triggered the issue (a completion-scale event,
            # not one stray freed page), or issue/cancel would flap at the
            # exhaustion boundary every iteration
            receded = self.allocator.num_free \
                >= self._growth_pages() + self.watermark_blocks
            if receded:
                self.allocator.swap_out_cancel(ticket, table)
                if self.swap_cancel_hook is not None:
                    self.swap_cancel_hook(pairs)
                self.waiting.remove(req)
                req.phase = Phase.INCREMENT if \
                    req.prefilled_len >= req.prompt_len else Phase.INITIATION
                req.last_planned_iter = self._iter_idx
                self.running.append(req)
                plan.swap_cancel.append((req, pairs))
                if tr is not None:
                    tr.end("swap", "pending", req.request_id,
                           outcome="cancel")
                    tr.instant("sched", "swap_cancel", rid=req.request_id,
                               pages=len(pairs))
            else:
                if self.swap_complete_hook is not None:
                    # engine copies device->host NOW — the pending ledger
                    # kept the source pages allocated across the overlap
                    # window, so they still hold the victim's KV
                    self.swap_complete_hook(pairs)
                self.allocator.swap_out_complete(ticket)
                # hold the victim out of readmission until pressure truly
                # recedes — the pages this complete just freed must become
                # decode headroom, not an immediate swap-in of the victim
                # they were taken from (see _swap_hold in __init__)
                self._swap_hold.add(req.request_id)
                plan.swap_complete.append((req, pairs))
                if tr is not None:
                    tr.end("swap", "pending", req.request_id,
                           outcome="complete")
                    # the pages have now actually left the device: emit the
                    # classic swap_out instant so the out/in balance
                    # invariant (validate_swap_balance) sees this request
                    # as host-resident from here on
                    tr.instant("sched", "swap_out", rid=req.request_id,
                               pages=len(pairs), trigger=req.request_id,
                               kind="speculative")

    def _rescind(self, plan: IterationPlan, victim: Request) -> None:
        """Remove work already planned this iteration for a preemption
        victim (its pages are gone): a granted decode token, a prefill
        chunk, or a pending COW copy must not reach the backend with a
        freed block table. Must run BEFORE :meth:`_preempt` frees the
        victim's table — the COW pairs are identified by their target
        blocks, which the victim still owns."""
        tr = self.trace
        if victim in plan.decode:
            plan.decode.remove(victim)
            self._budget += 1
            if tr is not None:
                tr.instant("req", "decode_rescind", rid=victim.request_id)
        for c in [c for c in plan.chunks if c.req is victim]:
            plan.chunks.remove(c)
            self._budget += c.length
            # roll back the progress the planner credited for this chunk:
            # its KV will never be computed, so leaving prefilled_len past
            # c.start would let a swap preserve — or the preemption path
            # cache-insert — pages holding garbage
            victim.prefilled_len = min(victim.prefilled_len, c.start)
            if tr is not None:
                tr.instant("req", "chunk_rescind", rid=victim.request_id,
                           start=c.start, length=c.length)
        if victim in plan.prefill:
            plan.prefill.remove(victim)
        # COW targets are freshly-allocated blocks exclusively owned by the
        # victim; once freed they can be REALLOCATED later this same
        # schedule() call (admission, prefix adoption), so a stale pending
        # copy would silently clobber the new owner's page contents
        table = self.tables.get(victim.request_id)
        if table is not None and plan.cow:
            owned = set(table.blocks)
            before = len(plan.cow)
            plan.cow[:] = [p for p in plan.cow if p[1] not in owned]
            if tr is not None and len(plan.cow) != before:
                tr.instant("sched", "cow_rescind", rid=victim.request_id,
                           pairs=before - len(plan.cow))

    def _plan_decodes(self, plan: IterationPlan) -> None:
        """Advance every running decode by one token (latency priority
        within its budget slice), preempting under page pressure."""
        if self.prefill_only and not self.decode_exempt:
            return  # disaggregated prefill role: decode happens elsewhere
        # under prefill_first this runs AFTER the chunk planners: a request
        # whose final chunk is planned this very iteration must not also be
        # granted a decode token (it samples its first token from the
        # prefill logits and enters decode NEXT iteration — otherwise a
        # max_new_tokens=1 request would emit two tokens at once)
        chunked_now = {c.req.request_id for c in plan.chunks}
        for req in list(self.running):
            if self._budget <= 0:
                break
            if self.prefill_only and \
                    req.request_id not in self.decode_exempt:
                continue  # only handoff-fallback requests decode here
            if req.request_id not in self.tables:
                continue  # became a preemption victim earlier this iteration
            if req not in self.running:
                continue  # swapped out earlier this very loop
            if req.prefilled_len < req.prompt_len or \
                    req.request_id in chunked_now:
                continue  # still prefilling / final chunk runs this iter
            table = self.tables[req.request_id]
            if not self.allocator.can_append(table, 1) and \
                    self.prefix_cache is not None:
                # reclaim unreferenced cached pages before preempting anyone
                self.prefix_cache.evict(self.allocator.blocks_needed(table, 1))
            if not self.allocator.can_append(table, 1):
                # _evict_one rescinds the victim's already-planned work for
                # this iteration, then swaps or sacrifices its pages
                victim = self._evict_one(exclude=req, plan=plan)
                if victim is not None and self.prefix_cache is not None \
                        and not self.allocator.can_append(table, 1):
                    # the victim's prompt pages may survive only as
                    # tree-held (refcount-1) cache pages — reclaim them
                    # before giving up on this request too
                    self.prefix_cache.evict(
                        self.allocator.blocks_needed(table, 1))
                if victim is None or not self.allocator.can_append(table, 1):
                    # evict this request itself (rescind any of its own
                    # planned work too — its device pages are going away)
                    self._rescind(plan, req)
                    self._preempt_or_swap(req, plan,
                                          trigger=req.request_id,
                                          kind="self")
                    continue
            plan.cow.extend(self.allocator.append_tokens(table, 1))
            plan.decode.append(req)
            req.last_planned_iter = self._iter_idx
            self._budget -= 1

    def _plan_continuations(self, plan: IterationPlan) -> None:
        """Budget-sized prefill chunks for running requests admitted in an
        earlier iteration whose prompt is not fully prefilled yet. No memory
        is needed — the whole prompt's pages were reserved at admission."""
        tr = self.trace
        for req in list(self.running):
            if self._budget <= 0:
                break
            if req.request_id not in self.tables:
                continue
            remaining = req.prompt_len - req.prefilled_len
            if remaining <= 0:
                continue
            # no sliver guard here: the request already holds its pages, so
            # stalling its continuation would waste memory to save an
            # iteration's overhead — admission is where slivers are refused
            n = min(remaining, self._budget)
            plan.chunks.append(PrefillChunk(req, req.prefilled_len, n))
            if tr is not None:
                tr.instant("req", "chunk", rid=req.request_id,
                           start=req.prefilled_len, length=n,
                           last=req.prefilled_len + n == req.prompt_len)
            req.prefilled_len += n
            req.last_planned_iter = self._iter_idx
            if req.prefilled_len == req.prompt_len:
                plan.prefill.append(req)
            self._budget -= n

    def _plan_admissions(self, plan: IterationPlan) -> None:
        """Admit waiting requests (FCFS) into leftover budget + memory. The
        whole prompt's pages are allocated up front; only the first chunk is
        charged against this iteration's budget."""
        while (self.waiting and self._budget > 0
               and len(self.running) < self.max_running):
            req = self.waiting[0]
            swapped = self.tables.get(req.request_id)
            if swapped is not None and swapped.on_host:
                # a swapped-out victim waits at the front of the queue
                # (FCFS, same as a sacrificed victim): it resumes — not
                # re-prefills — once the device can hold its pages again
                if not self._plan_swap_in(req, swapped, plan):
                    break  # head-of-line: device still too full
                continue
            path: list = []
            partial = None
            lease = None
            cached = 0
            bs = self.allocator.block_size
            if self.prefix_cache is not None and \
                    len(req.prompt) == req.prompt_len:
                # cap at prompt_len-1: the last prompt token must be computed
                # for the first-token logits even if fully cached
                path = self.prefix_cache.match(req.prompt,
                                               max_tokens=req.prompt_len - 1)
                cached = len(path) * bs
                if self.remote_adopter is not None:
                    lease = self.remote_adopter(req, cached)
                    if lease is not None and lease.num_tokens <= cached:
                        lease.release()  # not longer than the local match
                        lease = None
                    if lease is None:
                        # the adopter may have materialized the peer's pages
                        # locally (promote-to-copy after N leases) instead
                        # of granting a lease — re-match so this admission
                        # hits the fresh local pages
                        repath = self.prefix_cache.match(
                            req.prompt, max_tokens=req.prompt_len - 1)
                        if len(repath) > len(path):
                            path = repath
                            cached = len(repath) * bs
                if lease is not None:
                    # zero-copy admission: positions [0, lease.num_tokens)
                    # are served from the creditor's pages through the
                    # DistAttention merge — no local path is locked and only
                    # the suffix needs local pages
                    path = []
                    cached = lease.num_tokens
                else:
                    if self.prefix_importer is not None and \
                            self.prefix_importer(req.prompt, cached) > 0:
                        # adopt-imported-pages path: a peer published pages
                        # extending our local match and they were just
                        # grafted into the local tree — re-match over them
                        path = self.prefix_cache.match(
                            req.prompt, max_tokens=req.prompt_len - 1)
                    partial = self.prefix_cache.match_partial(
                        req.prompt, path, max_tokens=req.prompt_len - 1)
                    cached = len(path) * bs + (partial[1] if partial else 0)
            need_tokens = req.prompt_len - cached
            if self.chunk_policy == "solo":
                if need_tokens > self._budget:
                    # legacy stand-in: a prompt larger than the whole
                    # iteration budget may run alone when the instance is
                    # otherwise idle — else huge prompts
                    # head-of-line-block forever
                    solo_ok = plan.empty and not plan.preempted and \
                        self._budget == self.max_tokens
                    if not solo_ok:
                        if lease is not None:
                            lease.release()
                        if self.trace is not None:
                            self.trace.instant("sched", "refuse",
                                               rid=req.request_id,
                                               why="solo_wait")
                        break
                first_chunk = need_tokens
            elif self.chunk_policy == "monolithic":
                # no chunking: the whole prompt prefills this iteration,
                # right next to the running decodes (who all stall for it)
                first_chunk = need_tokens
            else:
                if self._budget < min(need_tokens, self.prefill_chunk_min):
                    if lease is not None:
                        lease.release()
                    if self.trace is not None:
                        self.trace.instant("sched", "refuse",
                                           rid=req.request_id,
                                           why="budget_sliver",
                                           budget=self._budget)
                    break  # not worth starting a prefill on a sliver
                first_chunk = min(need_tokens, self._budget)
            # lock before checking supply so eviction cannot claim the
            # matched pages out from under us. A token-level partial hit
            # locks the boundary node too: its page enters the table with
            # only the shared run counted as stored, so the allocator COWs
            # it on the first suffix write (the split-boundary copy).
            table = BlockTable()
            full_path = path + [partial[0]] if partial else path
            if full_path:
                table.blocks = self.prefix_cache.lock(full_path)
                table.num_tokens = cached
            # +1 block when the shared boundary page will be COW-copied;
            # the free-page bar excludes the prefill_first decode reserve
            needed = self.allocator.blocks_needed(table, need_tokens) + \
                (1 if partial else 0)
            avail = self.allocator.num_free - self.watermark_blocks - \
                self._decode_reserve
            if needed > avail and self.prefix_cache is not None:
                self.prefix_cache.evict(needed - avail)
                avail = self.allocator.num_free - self.watermark_blocks - \
                    self._decode_reserve
            if needed > avail:
                if full_path:  # roll back the lock
                    self.prefix_cache.release(full_path)
                    self.allocator.free_table(table)
                if lease is not None:
                    lease.release()
                if self.trace is not None:
                    self.trace.instant("sched", "refuse", rid=req.request_id,
                                       why="no_pages", needed=needed,
                                       avail=avail)
                break
            self.waiting.pop(0)
            plan.cow.extend(self.allocator.append_tokens(table, need_tokens))
            self.tables[req.request_id] = table
            if lease is not None:
                self.leases[req.request_id] = lease
                commit = getattr(lease, "commit", None)
                if commit is not None:  # stats/charges fire on commit only
                    commit()
            if full_path:
                self._cache_paths[req.request_id] = full_path
            req.num_cached_tokens = cached
            if self.prefix_cache is not None:
                self.prefix_cache.record_admission(req.prompt_len, cached,
                                                   full_path)
            req.phase = Phase.INITIATION
            self.running.append(req)
            plan.chunks.append(PrefillChunk(req, cached, first_chunk))
            tr = self.trace
            if tr is not None:
                tr.instant("sched", "admit", rid=req.request_id,
                           cached=cached,
                           leased=lease.num_tokens if lease is not None else 0,
                           chunk=first_chunk, policy=self.chunk_policy)
                if lease is not None:
                    tr.instant("lease", "acquire", rid=req.request_id,
                               tokens=lease.num_tokens)
                tr.instant("req", "chunk", rid=req.request_id, start=cached,
                           length=first_chunk,
                           last=cached + first_chunk == req.prompt_len)
            req.prefilled_len = cached + first_chunk
            req.last_planned_iter = self._iter_idx
            if req.prefilled_len == req.prompt_len:
                plan.prefill.append(req)
            self._budget -= first_chunk

    def _plan_swap_in(self, req: Request, table: BlockTable,
                      plan: IterationPlan) -> bool:
        """Try to re-materialize a swapped-out request's pages on device.
        Returns True when the queue head was consumed (swapped in, or its
        snapshot abandoned), False to head-of-line-block this iteration."""
        bs = self.allocator.block_size
        # the pages to restore, plus the growth block the next decode
        # append may need (checked against supply, not allocated)
        growth = max(0, -(-(table.num_tokens + 1) // bs)
                     - len(table.host_blocks))
        need = len(table.host_blocks) + growth
        avail = self.allocator.num_free - self.watermark_blocks - \
            self._decode_reserve
        if need > avail and self.prefix_cache is not None:
            self.prefix_cache.evict(need - avail)
            avail = self.allocator.num_free - self.watermark_blocks - \
                self._decode_reserve
        if need > avail:
            if need > self.allocator.num_blocks - self.watermark_blocks:
                # this context can NEVER fit on device again (it filled the
                # pool and still needs to grow): the snapshot is useless —
                # degrade to sacrifice so re-admission (and the
                # max_preemptions drop budget) takes over
                self._abandon_swap(req, table, plan)
                return True
            if self.trace is not None:
                self.trace.instant("sched", "refuse", rid=req.request_id,
                                   why="swap_wait", needed=need, avail=avail)
            return False
        if req.request_id in self._swap_hold:
            # speculatively swapped out: only readmit once the pool holds
            # its need PLUS a full watermark of slack, i.e. the pressure
            # that justified the early swap-out has genuinely receded
            # (typically a resident completed). Readmitting into a pool
            # that barely fits would undo the eviction one iteration later.
            if avail < need + self.watermark_blocks:
                if self.trace is not None:
                    self.trace.instant("sched", "refuse",
                                       rid=req.request_id, why="swap_hold",
                                       needed=need, avail=avail)
                return False
            self._swap_hold.discard(req.request_id)
        pairs = self.allocator.swap_in(table)
        if self.swap_in_hook is not None:
            # engine copies host->device; nothing reads the fresh blocks
            # before its next compute, but copying now keeps the hook
            # symmetric with swap_out and the pages immediately coherent
            self.swap_in_hook(pairs)
        self.waiting.pop(0)
        # resume EXACTLY where the swap interrupted: a fully-prefilled
        # request re-enters decode (no chunks — the acceptance criterion),
        # a mid-prefill victim continues chunking from its preserved
        # prefilled_len via _plan_continuations
        req.phase = Phase.INCREMENT if req.prefilled_len >= req.prompt_len \
            else Phase.INITIATION
        req.last_planned_iter = self._iter_idx
        self.running.append(req)
        plan.swap_in.append((req, pairs))
        if self.trace is not None:
            self.trace.instant("sched", "swap_in", rid=req.request_id,
                               pages=len(pairs),
                               prefilled=req.prefilled_len,
                               generated=req.n_generated)
        return True

    def _abandon_swap(self, req: Request, table: BlockTable,
                      plan: IterationPlan) -> None:
        """Drop a host snapshot that can never be swapped back in and reset
        the request to recompute-from-scratch semantics (same bookkeeping
        as :meth:`_preempt`, but the request is already in ``waiting``)."""
        self._swap_hold.discard(req.request_id)
        req.phase = Phase.PREEMPTED
        req.preemptions += 1
        req.prompt = (req.prompt + req.output) if req.prompt else req.prompt
        req.prompt_len = req.context_len
        req.max_new_tokens -= req.n_generated
        req.committed_output.extend(req.output)
        req.output = []
        req.num_cached_tokens = 0
        req.prefilled_len = 0
        self.allocator.free_table(self.tables.pop(req.request_id))
        plan.preempted.append(req)  # the drop budget applies
        if self.trace is not None:
            self.trace.instant("sched", "preempt", rid=req.request_id,
                               trigger=req.request_id, kind="swap_abandon")

    def complete_iteration(self, plan: IterationPlan, now: float) -> List[Request]:
        """Mark phases + retire finished requests. Returns finished list."""
        finished = []
        tr = self.trace
        for req in plan.prefill:
            req.phase = Phase.INCREMENT
            if req.first_token_time is None:
                req.first_token_time = now
                if tr is not None:
                    tr.instant("req", "first_token", rid=req.request_id,
                               ts=now)
            # adopt the prompt's full pages into the radix tree as soon as
            # their KV exists — waiting for request completion would make
            # every member of a same-prefix burst recompute the shared
            # prefix (thundering herd). A leased request's local pages hold
            # only its suffix (the leading positions live on the creditor
            # instance), so there is nothing page-0-aligned to insert.
            if self.prefix_cache is not None and \
                    len(req.prompt) == req.prompt_len and \
                    req.request_id in self.tables and \
                    req.request_id not in self.leases:
                self.prefix_cache.insert(
                    req.prompt, self.tables[req.request_id].blocks)
        for req in plan.prefill + plan.decode:
            if req.done:
                self.finish(req, now)
                finished.append(req)
        # preemption budget: a request churning through recomputes is dropped
        # (reported as "preempted-dropped") instead of thrashing forever
        if self.max_preemptions is not None:
            for req in plan.preempted:
                # still in waiting = not re-admitted this very iteration
                if req.preemptions > self.max_preemptions and \
                        req in self.waiting:
                    self.waiting.remove(req)
                    self.finish(req, now, reason="preempted-dropped")
                    finished.append(req)
        return finished

    # -- disaggregated handoff ------------------------------------------------
    def release_request(self, req: Request) -> None:
        """Detach a prefill-complete request from this scheduler WITHOUT
        finishing it (the prefill side of a KV handoff). The caller must
        have secured the KV first — exported page payloads for a migration,
        or lent the blocks (increfs) for a zero-copy lease — because the
        local block table is freed here. The request's telemetry span stays
        open: it ends on the instance that finishes the decode."""
        lease = self.leases.pop(req.request_id, None)
        if lease is not None:  # repay any creditor before local frees
            lease.release()
        self._release_cache_path(req)
        table = self.tables.pop(req.request_id, None)
        if table is not None:
            self.allocator.free_table(table)
        if req in self.running:
            self.running.remove(req)
        self.decode_exempt.discard(req.request_id)

    def install_running(self, req: Request, table: BlockTable,
                        lease: Optional[object] = None) -> None:
        """Adopt a request mid-flight (the decode side of a KV handoff):
        its prompt KV already exists — in ``table``'s local pages (migrate)
        and/or on the creditor instance under ``lease`` (zero-copy). The
        request enters decode directly; no admission, no prefill."""
        req.phase = Phase.INCREMENT
        self.tables[req.request_id] = table
        if lease is not None:
            self.leases[req.request_id] = lease
        self.running.append(req)

    # -- best-of-n forks ------------------------------------------------------
    def fork_from(self, parent: Request, child: Request) -> BlockTable:
        """COW-fork ``child`` off ``parent`` right after the parent's
        prefill: every prompt page is shared (refcounted; the first write
        into a shared partial page triggers copy-on-write in
        ``append_tokens``) and the child enters decode directly — no second
        prefill. The caller samples the child's first token from the
        parent's prefill logits."""
        table = self.allocator.fork(self.tables[parent.request_id])
        self.tables[child.request_id] = table
        tr = self.trace
        if tr is not None:
            tr.begin("request", "req", child.request_id,
                     fork_of=parent.request_id,
                     prompt_len=parent.prompt_len,
                     max_new_tokens=child.max_new_tokens)
        lease = self.leases.get(parent.request_id)
        if lease is not None:
            # the sibling reads the same borrowed prefix: share the lease
            # (refcounted — the creditor is repaid when the last holder
            # releases)
            self.leases[child.request_id] = lease.acquire()
            if tr is not None:
                tr.instant("lease", "acquire", rid=child.request_id,
                           tokens=lease.num_tokens, shared=True)
        child.prompt = list(parent.prompt)
        child.prompt_len = parent.prompt_len
        child.num_cached_tokens = parent.prompt_len  # nothing recomputed
        child.prefilled_len = parent.prompt_len
        child.phase = Phase.INCREMENT
        self.running.append(child)
        return table

    # -- preemption ----------------------------------------------------------------
    def _preempt(self, req: Request) -> None:
        req.phase = Phase.PREEMPTED
        req.preemptions += 1
        # keep the victim's prefix-cache credit: its prefilled prompt pages
        # hold REAL computed KV, so adopt the full ones into the radix tree
        # BEFORE the table is freed. Re-admission then re-probes the tree
        # and the recompute covers only the uncached suffix — previously a
        # mid-prefill victim restarted chunking from token 0 even though
        # its completed chunks' pages were still sitting in memory.
        # (Decode-phase victims' prompt pages were already inserted at
        # prefill completion; insert() dedups.) Leased requests are
        # excluded — their leading pages live on the creditor — and so are
        # sim requests with immaterial prompts.
        if self.prefix_cache is not None and req.prefilled_len > 0 \
                and req.request_id not in self.leases \
                and len(req.prompt) == req.prompt_len:
            table = self.tables.get(req.request_id)
            if table is not None and not table.on_host:
                n = min(req.prefilled_len, table.num_tokens)
                self.prefix_cache.insert(req.prompt[:n], table.blocks)
        # recompute policy: drop pages; generated tokens move into the prompt
        req.prompt = (req.prompt + req.output) if req.prompt else req.prompt
        req.prompt_len = req.context_len
        req.max_new_tokens -= req.n_generated
        req.committed_output.extend(req.output)
        req.output = []
        req.num_cached_tokens = 0  # re-matched at the next admission
        req.prefilled_len = 0  # recompute restarts chunked prefill
        # debtor preemption: repay the creditor of a borrowed prefix BEFORE
        # freeing any local page (re-admission may take a fresh lease)
        lease = self.leases.pop(req.request_id, None)
        if lease is not None:
            lease.release()
            if self.trace is not None:
                self.trace.instant("lease", "release", rid=req.request_id,
                                   tokens=lease.num_tokens, cause="preempt")
        self._release_cache_path(req)
        self.allocator.free_table(self.tables.pop(req.request_id))
        if req in self.running:
            self.running.remove(req)
        self.waiting.insert(0, req)

    def _victim_cost(self, req: Request) -> float:
        """Raw eviction bill of ``req`` in seconds. A victim that would
        *swap* costs its PCIe round trip; one that would *sacrifice* costs
        the quadratic recompute of its context. ``victim_cost_fn``
        (sim/engine-wired) overrides the built-in mirror of the sim's
        CostModel/NetworkModel defaults."""
        table = self.tables[req.request_id]
        if self.victim_cost_fn is not None:
            return self.victim_cost_fn(req, table)
        n = len(table.blocks)
        ctx = min(req.prefilled_len, table.num_tokens) + req.n_generated
        if self._should_swap(req):
            from repro_torch.core.distkv.netmodel import NetworkModel
            return 2.0 * NetworkModel().swap_time(n)
        # CostModel defaults: c_token * ctx + c_ctx * attention reads
        return 12e-6 * ctx + 18e-9 * (ctx * (ctx - 1) // 2)

    def _pick_from(self, cands: List[Request], needed: int = 1) -> Request:
        """Rank non-empty ``cands`` per ``victim_policy``. ``needed`` is
        the current page shortfall: the ``cost`` policy ranks by eviction
        seconds per page freed *toward that shortfall* — a small decode
        hole favors the victim with the cheapest absolute bill (evicting a
        giant frees pages nobody asked for), while a bulk shortfall
        amortizes a big victim's bill over everything it frees."""
        if self.victim_policy == "cost":
            return min(cands, key=lambda r: self._victim_cost(r) / max(
                1, min(len(self.tables[r.request_id].blocks), needed)))
        if self.victim_policy == "fifo":
            return cands[0]
        if self.victim_policy == "lru":
            return min(cands, key=lambda r: r.last_planned_iter)
        return cands[-1]  # lifo: youngest, least sunk work (vLLM default)

    def _pick_victim(self, exclude: Request,
                     needed: int = 1) -> Optional[Request]:
        """Choose who loses their device pages, per ``victim_policy``.

        Under ``swap_mode="auto"`` swap-worthiness is evaluated PER
        CANDIDATE before ranking: a candidate whose KV is worth moving
        (cheap PCIe vs expensive recompute) beats one that would have to
        sacrifice, whatever the positional order says — previously the
        policy locked in a victim first and only then asked whether
        swapping it was worthwhile, so auto could pick a must-recompute
        victim while a cheap-to-swap one sat right next to it."""
        cands = [r for r in self.running
                 if r is not exclude and r.request_id in self.tables]
        if not cands:
            return None
        if self.swap_mode == "auto":
            worthy = [r for r in cands if self._should_swap(r)]
            if worthy:
                cands = worthy
        return self._pick_from(cands, needed)

    def _evict_one(self, exclude: Request,
                   plan: IterationPlan) -> Optional[Request]:
        """Pick a victim, rescind its planned work, and take its device
        pages — by swap when the mode/decider says the KV is worth the PCIe
        round trip, by sacrifice (recompute) otherwise."""
        table = self.tables.get(exclude.request_id)
        needed = self.allocator.blocks_needed(table, 1) if table is not None \
            else 1
        victim = self._pick_victim(exclude, needed=max(1, needed))
        if victim is None:
            return None
        self._rescind(plan, victim)
        self._preempt_or_swap(victim, plan, trigger=exclude.request_id,
                              kind="victim")
        return victim

    def _should_swap(self, req: Request) -> bool:
        if self.swap_mode == "sacrifice" or \
                self.allocator.num_host_blocks == 0:
            return False
        if req.request_id in self.leases:
            # a leased prefix lives on the creditor — the local pages are
            # only the suffix, and the lease must be repaid now, so a host
            # snapshot could not be resumed coherently. Sacrifice.
            return False
        table = self.tables.get(req.request_id)
        if table is None or not self.allocator.can_swap_out(table):
            return False  # host tier full: degrade to sacrifice
        if self.swap_mode == "swap":
            return True
        computed = min(req.prefilled_len, table.num_tokens) + req.n_generated
        if self.swap_decider is not None:
            return self.swap_decider(req, len(table.blocks))
        return computed >= self.swap_min_tokens

    def _preempt_or_swap(self, req: Request, plan: IterationPlan, *,
                         trigger: int, kind: str) -> None:
        """Evict ``req``'s device pages. Swap: the KV moves to host pages
        and the request re-enters WAITING still holding its table (and its
        prefill/decode progress) — swap-in resumes exactly where it
        stopped, no recompute. Sacrifice: classic preempt-by-recompute."""
        tr = self.trace
        if self._should_swap(req):
            table = self.tables[req.request_id]
            # the locked radix path's pages stay device-resident for the
            # tree (swap_out only drops THIS table's refs); release the
            # pins so they become evictable while we are away
            self._release_cache_path(req)
            pairs = self.allocator.swap_out(table)
            if self.swap_out_hook is not None:
                # engine copies device->host NOW, before anything later in
                # this schedule() can reallocate-and-write the freed pages
                self.swap_out_hook(pairs)
            req.swaps += 1
            req.phase = Phase.WAITING
            self.running.remove(req)
            self.waiting.insert(0, req)
            plan.swap_out.append((req, pairs))
            if tr is not None:
                tr.instant("sched", "swap_out", rid=req.request_id,
                           pages=len(pairs), trigger=trigger, kind=kind)
        else:
            self._preempt(req)
            plan.preempted.append(req)
            if tr is not None:
                tr.instant("sched", "preempt", rid=req.request_id,
                           trigger=trigger, kind=kind)
