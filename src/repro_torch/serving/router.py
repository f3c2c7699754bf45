"""Multi-instance cluster router: one ServingBackend over N serving instances.

The paper's serving endgame (InfiniteLLM-style cluster serving) is many LLM
service instances behind one front door. :class:`RouterBackend` is that
front door as a *backend*: it implements the same ``ServingBackend``
protocol as ``PagedEngine``, over N child backends, so ``LLMService``
drives a whole cluster exactly like a single instance.

A copy of ``repro.serving.router`` with its imports changed. The children
here are the port's ``PagedEngine``s; the reference's cost-model
``SimBackend`` is not ported yet. The branches that serve a simulator
child (a virtual clock, payload-less pages) stay as they are: each is
guarded by ``getattr`` / ``hasattr`` on the child, so engine children
never take them.

Placement is pluggable (``POLICIES``):

* ``round_robin``     — cycle through instances (the classic baseline);
* ``least_loaded``    — fewest queued+running requests, then the smallest
  in-flight **prefill token backlog** (queued prompts + unprefilled
  remainders of running chunked prefills), then most free KV pages (a
  stand-in for the load heartbeats a real gManager aggregates);
* ``prefix_affinity`` — probe every instance's radix tree for the longest
  cached match of the prompt and route to the best one (SGLang-style
  cache-aware routing); below a match threshold fall back to least-loaded
  so cold traffic still spreads.

Cross-instance prefix sharing (``prefix_share=True``) layers the distkv
publication board underneath placement: after each step the router exports
any radix path whose hit count crossed ``hot_threshold`` from its owning
instance — token keys + page payloads — and publishes it through the
cluster's :class:`~repro_torch.core.distkv.gmanager.GManager`. Each child
scheduler gets a ``prefix_importer`` hook, so at admission an instance that
only partially matches a prompt locally adopts the published extension into
its *own* radix tree (fresh local blocks, payloads copied in) instead of
recomputing the shared system prompt. A hot prefix is therefore computed
once cluster-wide and then served everywhere, even under round-robin
placement.

``share_mode`` picks how a published prefix reaches a peer:

* ``copy`` (default) — payload adoption as above: page contents are shipped
  once and live on in the peer's own radix tree;
* ``zero_copy`` — borrowed rBlocks: the peer's scheduler admits the request
  with a :class:`~repro_torch.core.distkv.rmanager.RemoteLease` on the home
  instance's *physical* pages (pinned on the board, refcounted through the
  home allocator, debt tracked in the gManager ledger) and the engine
  serves them in place through the DistAttention partial ``(o, m, l)``
  merge — no payload ever moves, at the price of a per-iteration merge;
* ``auto`` — per-request decision by the
  :class:`~repro_torch.core.distkv.netmodel.NetworkModel`: borrow when the
  estimated lifetime merge overhead undercuts the one-time payload copy
  (hot short prefixes borrow, long prefixes ahead of long decodes copy).

``net`` attaches that network cost model; virtual-clock children charge
copies and lease RPCs against their clock, wall-clock engines record them
as ``net_time``.

Disaggregated prefill/decode serving layers *roles* on top: pass
``InstanceSpec``-wrapped children and/or ``roles="2p2d"`` and the router
places new prompts only on prefill-capable instances, parks prefill-only
schedulers in ``prefill_only`` mode, and runs a
:class:`~repro_torch.serving.disagg.KVHandoff` coordinator at the top of every
step that moves finished prompt KV to a decode instance (migrated payloads
or a zero-copy ``RemoteLease``, ``handoff_mode`` choosing per request in
``auto``). See ``serving/disagg.py`` for the full design.

Clock semantics: with all-virtual children (simulators) the router is
event-driven — each ``step`` advances the laggard instance, and ``clock()``
reports the cluster frontier, so policy sweeps over many instances run in
milliseconds. With any wall-clock child, ``step`` fans out to every
instance with work and ``clock()`` stays ``None`` (caller time), matching
the single-engine contract.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.distkv.gmanager import GManager, Heartbeat
from repro_torch.core.distkv.netmodel import NetworkModel
from repro_torch.core.distkv.rmanager import RManager
from repro_torch.core.scheduling.request import Request
from repro_torch.core.telemetry import Tracer, merge_events
from repro_torch.serving.disagg import (HANDOFF_MODES, InstanceSpec, KVHandoff,
                                  parse_role_spec)

SHARE_MODES = ("copy", "zero_copy", "auto")


def _load_of(child) -> Tuple[int, int]:
    """Load of a child backend, lexicographic: (queued + running requests,
    prefill backlog tokens). The second component counts **in-flight prefill
    work** — queued prompts plus the unprefilled remainder of running
    chunked prefills — so an instance grinding through a 100k-token prompt
    ranks busier than a peer with the same request count serving chats."""
    sched = child.scheduler
    backlog = sched.prefill_backlog_tokens() \
        if hasattr(sched, "prefill_backlog_tokens") else 0
    return (len(sched.waiting) + len(sched.running), backlog)


def _free_pages_of(child) -> int:
    return child.allocator.num_free


class RoundRobinPolicy:
    """Cycle through instances in submission order."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, req: Request, children: Sequence) -> int:
        i = self._next % len(children)
        self._next += 1
        return i


class LeastLoadedPolicy:
    """Fewest queued+running requests, then smallest in-flight prefill
    token backlog; remaining ties go to the most free KV pages."""

    name = "least_loaded"

    def choose(self, req: Request, children: Sequence) -> int:
        return min(range(len(children)),
                   key=lambda i: (_load_of(children[i]),
                                  -_free_pages_of(children[i]), i))


class PrefixAffinityPolicy:
    """Route to the instance whose radix tree holds the longest cached
    match for the prompt (side-effect-free probe). Ties between equally-good
    matches break by load, and a match below ``min_match_tokens`` (default:
    one page) falls back to least-loaded — cold prompts must not pile onto
    instance 0."""

    name = "prefix_affinity"

    def __init__(self, min_match_tokens: Optional[int] = None):
        self.min_match_tokens = min_match_tokens
        self._fallback = LeastLoadedPolicy()

    def _match_tokens(self, child, prompt) -> int:
        pc = getattr(child, "prefix_cache", None)
        if pc is None:
            return 0
        path = pc.match(prompt, max_tokens=len(prompt) - 1, probe=True)
        return len(path) * pc.page_size

    def choose(self, req: Request, children: Sequence) -> int:
        prompt = req.prompt
        if not prompt:  # length-only (simulator) request: nothing to match
            return self._fallback.choose(req, children)
        matches = [self._match_tokens(c, prompt) for c in children]
        best = max(matches)
        threshold = self.min_match_tokens
        if threshold is None:
            pcs = [getattr(c, "prefix_cache", None) for c in children]
            threshold = min((pc.page_size for pc in pcs if pc is not None),
                            default=1)
        if best < threshold:
            return self._fallback.choose(req, children)
        cands = [i for i, m in enumerate(matches) if m == best]
        return min(cands, key=lambda i: (_load_of(children[i]),
                                         -_free_pages_of(children[i]), i))


POLICIES = {
    "round_robin": RoundRobinPolicy,
    "least_loaded": LeastLoadedPolicy,
    "prefix_affinity": PrefixAffinityPolicy,
}


@dataclasses.dataclass
class _AggregateCacheStats:
    """Duck-typed stand-in for a single PrefixCache in ``LLMService.stats``:
    cluster-wide hit rate over all children's radix trees."""

    hit_tokens: int = 0
    lookup_tokens: int = 0
    num_pages: int = 0
    adopted_pages: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0


class RouterBackend:
    """ServingBackend over N child backends with pluggable placement.

    ``children`` are fully-constructed backends (``PagedEngine``s). ``policy`` is a name from :data:`POLICIES` or
    a policy object with ``choose(req, children) -> int``.

    ``prefix_share=True`` enables cross-instance prefix sharing through the
    distkv publication board (children need ``prefix_cache`` attached):
    radix paths matched by >= ``hot_threshold`` later requests are published
    with their page payloads, and peers adopt them at admission.
    """

    def __init__(self, children: Sequence, *,
                 policy: Union[str, object] = "round_robin",
                 prefix_share: bool = False,
                 share_mode: str = "copy",
                 hot_threshold: int = 1,
                 board_pages: Optional[int] = None,
                 net: Optional[NetworkModel] = None,
                 gmanager: Optional[GManager] = None,
                 roles: Optional[Union[str, Sequence[str]]] = None,
                 handoff_mode: str = "auto",
                 handoff_defer_cap: int = 8,
                 promote_after: Optional[int] = None,
                 peer_spill: bool = False):
        if not children:
            raise ValueError("RouterBackend needs at least one child backend")
        if share_mode not in SHARE_MODES:
            raise ValueError(f"share_mode must be one of {SHARE_MODES}, "
                             f"got {share_mode!r}")
        if share_mode != "copy" and not prefix_share:
            raise ValueError("share_mode needs prefix_share=True "
                             "(there is nothing to serve without the board)")
        # role-tagged membership: children may be bare backends (role
        # "mixed" — the previous N-identical-children behavior) or
        # InstanceSpec wrappers; roles= applies a spec ("2p2d") on top
        specs = [c if isinstance(c, InstanceSpec) else InstanceSpec(c)
                 for c in children]
        if roles is not None:
            role_list = parse_role_spec(roles)
            if len(role_list) != len(specs):
                raise ValueError(
                    f"roles spec names {len(role_list)} instances but "
                    f"{len(specs)} children were supplied")
            specs = [InstanceSpec(s.backend, role)
                     for s, role in zip(specs, role_list)]
        self.children = [s.backend for s in specs]
        self.roles = [s.role for s in specs]
        self.disaggregated = any(r != "mixed" for r in self.roles)
        self.prefill_capable = [i for i, r in enumerate(self.roles)
                                if r in ("prefill", "mixed")]
        self.decode_capable = [i for i, r in enumerate(self.roles)
                               if r in ("decode", "mixed")]
        self.prefill_only = [i for i, r in enumerate(self.roles)
                             if r == "prefill"]
        self.policy = POLICIES[policy]() if isinstance(policy, str) else \
            policy
        self.prefix_share = prefix_share
        self.share_mode = share_mode
        self.promote_after = promote_after
        self.promotions = 0
        # auto needs a cost model to decide, and disaggregation charges the
        # handoff transfer; zero_copy/copy work without one (network then
        # costs nothing on virtual clocks)
        self.net = net or (NetworkModel()
                           if share_mode == "auto" or self.disaggregated
                           or peer_spill
                           else None)
        self.hot_threshold = hot_threshold
        # board_pages: size cap for the publication board (LRU page
        # eviction) — ignored when an explicit gmanager is supplied
        self.g = gmanager or GManager(len(self.children),
                                      prefix_board_pages=board_pages)
        self.requests_placed: List[int] = [0] * len(self.children)
        self._placement: Dict[int, int] = {}  # request id -> instance
        # last-seen prefix_cache.hit_tokens per child: hot-path publication
        # (draining the cache's recently-hit list) and heartbeats only run
        # after an iteration that committed new cache hits
        self._last_hits: List[int] = [0] * len(self.children)
        self._virtual = all(c.clock() is not None for c in self.children)
        # zero-copy lease stats (cumulative; the gManager ledger holds the
        # *outstanding* debt)
        self.leases_granted = 0
        self.pages_borrowed = 0
        self.rms: Dict[int, RManager] = {}
        if prefix_share:
            sizes = set()
            for i, child in enumerate(self.children):
                if getattr(child, "prefix_cache", None) is None:
                    raise ValueError(
                        f"prefix_share needs a prefix cache on every child; "
                        f"instance {i} has none")
                sizes.add(child.prefix_cache.page_size)
            if len(sizes) > 1:
                # adoption re-chunks published token keys by the adopter's
                # local page size — only sound when pages are interchangeable
                raise ValueError(
                    f"prefix_share needs one page size across instances, "
                    f"got {sorted(sizes)}")
            # page *size* alone does not make pages interchangeable: the
            # per-token payload schema (KVPageLayout) must match too — a
            # GQA home's K/V page adopted into an MLA peer's latent pool
            # (or vice versa) would be silently-reinterpreted garbage
            schemas = {c.kv_layout.schema for c in self.children
                       if getattr(c, "kv_layout", None) is not None}
            if len(schemas) > 1:
                raise ValueError(
                    f"KV layout schema mismatch across prefix_share "
                    f"instances: {sorted(schemas)} — cross-instance page "
                    "payloads are only interchangeable between identical "
                    "layouts")
            for i, child in enumerate(self.children):
                child.prefix_cache.track_hot = True
                if share_mode != "zero_copy":
                    child.scheduler.prefix_importer = self._make_importer(i)
            if share_mode != "copy":
                self._wire_zero_copy()
        # peer KV spill tier: a child's radix cache parks cold pages in a
        # neighbor's free device memory (lent rBlocks, NVLink lane) before
        # falling back to its host tier
        self.peer_spill = peer_spill
        if peer_spill:
            for i, child in enumerate(self.children):
                if getattr(child, "prefix_cache", None) is None:
                    raise ValueError(
                        f"peer_spill needs a prefix cache on every child; "
                        f"instance {i} has none")
                if not child.prefix_cache.spill_budget:
                    raise ValueError(
                        f"peer_spill needs cache_spill_pages > 0 on every "
                        f"child (the budget bounds peer+host spilled pages);"
                        f" instance {i} has 0")
            self._wire_peer_spill()
        # disaggregated prefill/decode: park prefill-only schedulers in
        # prefill_only mode and stand up the KV handoff coordinator
        self.handoff = None
        self.handoff_zc_ok = False
        if self.disaggregated:
            if not self.prefill_capable:
                raise ValueError(
                    "role spec has no prefill-capable (prefill/mixed) "
                    "instance to place prompts on")
            if not self.decode_capable:
                raise ValueError(
                    "role spec has no decode-capable (decode/mixed) "
                    "instance to hand finished KV to")
            if handoff_mode not in HANDOFF_MODES:
                raise ValueError(
                    f"handoff_mode must be one of {HANDOFF_MODES}, "
                    f"got {handoff_mode!r}")
            kinds = {hasattr(c, "k_pages") for c in self.children}
            if len(kinds) > 1:
                raise ValueError(
                    "disaggregated roles need homogeneous children (all "
                    "engines or all sims): prompt KV cannot move between "
                    "a cost-model sim and a real engine")
            zc_capable = all(getattr(c, "_window", None) is None
                             for c in self.children)
            if handoff_mode == "zero_copy" and not zc_capable:
                raise ValueError(
                    "zero_copy handoff is unsupported with sliding-window "
                    "attention children (the remote partial ignores the "
                    "window) — use handoff_mode='migrate' or 'auto'")
            self.handoff_zc_ok = zc_capable
            if handoff_mode != "migrate" and zc_capable:
                self._wire_rmanagers()
            for i in self.prefill_only:
                self.children[i].scheduler.prefill_only = True
            self.handoff = KVHandoff(self, mode=handoff_mode,
                                     defer_cap=handoff_defer_cap)
        # telemetry: children constructed with tracing enabled each carry a
        # Tracer — assign them per-instance track ids, give the router its
        # own track (placement, board, network events) one past the last
        # child, and point each rManager/board at the right tracer. All
        # merged onto one timeline by trace_events().
        self.trace = None
        traced = [getattr(c, "trace", None) for c in self.children]
        if any(t is not None for t in traced):
            for i, t in enumerate(traced):
                if t is not None:
                    t.instance = i
            # with all-virtual children clock() is the cluster frontier;
            # with wall-clock children it is None — router events then sit
            # at t=0 unless stamped explicitly (add_request passes ts)
            self.trace = Tracer(
                clock=lambda: self.clock() or 0.0,
                instance=len(self.children))
            self.g.prefix_board.trace = self.trace
            for i, rm in self.rms.items():
                rm.trace = traced[i]
        self._heartbeat_all()

    def _wire_rmanagers(self) -> None:
        """Per-instance rManagers over the shared gManager (debt ledger)
        plus creditor pool readers on engine children — the substrate both
        zero-copy prefix serving and leased KV handoffs run on. Idempotent:
        prefix sharing and disaggregation may each ask for it."""
        if self.rms:
            return
        self.rms = {i: RManager(i, c.allocator, self.g)
                    for i, c in enumerate(self.children)}
        for rm in self.rms.values():
            rm.register_peers(self.rms)
        for child in self.children:
            if hasattr(child, "k_pages"):  # engine: needs creditor pools
                child.remote_reader = self._read_pools

    def _wire_zero_copy(self) -> None:
        """Borrowed-rBlock serving: rManagers (:meth:`_wire_rmanagers`),
        board pins so a home cannot free a published (lendable) page, and
        the schedulers' remote_adopter hooks."""
        self._wire_rmanagers()
        board = self.g.prefix_board
        board.on_pin = \
            lambda home, block: self.children[home].allocator.incref(block)
        board.on_unpin = \
            lambda home, block: self.children[home].allocator.decref(block)
        for i, child in enumerate(self.children):
            if self.roles[i] == "prefill":
                # a prefill-only child never decodes a leased prefix; an
                # admission lease here would have to chain through the KV
                # handoff — keep its prefix reuse on the copy/local paths
                continue
            child.scheduler.remote_adopter = self._make_remote_adopter(i)

    def _read_pools(self, home: int):
        c = self.children[home]
        return c.k_pages, c.v_pages

    def _wire_peer_spill(self) -> None:
        """Attach the radix peer-spill hooks on every child: spill-out
        lends one block from the neighbor with the most free device memory
        (``RManager.try_lend``, debt in the gManager ledger) and ships the
        payload over the NVLink lane; restore copies it back onto a fresh
        local block and repays the loan. Payload copies are getattr-guarded
        so cost-model sims ride the same wiring bookkeeping-only."""
        self._wire_rmanagers()
        for i, child in enumerate(self.children):
            pc = child.prefix_cache
            pc.peer_spill_fn = self._make_peer_spiller(i)
            pc.peer_restore_fn = self._make_peer_restorer(i)
            pc.peer_drop_fn = self._make_peer_dropper(i)

    def _kv_page_bytes(self, i: int):
        """True bytes per KV page on child ``i`` (from its allocator's
        KVPageLayout), or None to fall back on the NetworkModel's default —
        compressed layouts (MLA latent pages) move ~10x fewer bytes than
        the GQA default would charge."""
        return getattr(getattr(self.children[i], "allocator", None),
                       "page_bytes", None)

    def _net_bytes(self, i: int, n_pages: int) -> int:
        pb = self._kv_page_bytes(i)
        return n_pages * (pb if pb is not None else self.net.page_bytes)

    def _charge_peer_copy(self, i: int, n_pages: int) -> None:
        if self.net is None:
            return
        charge = getattr(self.children[i], "charge_network", None)
        if charge is not None:
            charge(self.net.peer_copy_time(
                n_pages, page_bytes=self._kv_page_bytes(i)))

    def _make_peer_spiller(self, i: int):
        child = self.children[i]
        child_is_engine = hasattr(child, "k_pages")

        def spill(dev_block: int):
            # neighbor with the most free device pages (same backend kind:
            # a payload cannot move between a cost-model sim and an engine)
            best, best_free = None, -1
            for j, peer in enumerate(self.children):
                if j == i or hasattr(peer, "k_pages") != child_is_engine:
                    continue
                free = peer.allocator.num_free
                if free > self.g.safety_free and free > best_free:
                    best, best_free = j, free
            if best is None:
                return None
            blk = self.rms[best].try_lend(debtor=i)
            if blk is None:
                return None
            if child_is_engine:
                # copy while the source device page is still allocated
                self.children[best].import_page_payloads(
                    [blk], [child.export_page_payload(dev_block)])
            self._charge_peer_copy(i, 1)
            if self.trace is not None:
                self.trace.instant("net", "peer_spill", src=i, home=best,
                                   pages=1)
            return best, blk

        return spill

    def _make_peer_restorer(self, i: int):
        child = self.children[i]

        def restore(home: int, peer_block: int, dev_block: int) -> None:
            exp = getattr(self.children[home], "export_page_payload", None)
            write = getattr(child, "import_page_payloads", None)
            if exp is not None and write is not None:
                write([dev_block], [exp(peer_block)])
            self.rms[i].repay(home, peer_block)
            self._charge_peer_copy(i, 1)
            if self.trace is not None:
                self.trace.instant("net", "peer_restore", dst=i, home=home,
                                   pages=1)

        return restore

    def _make_peer_dropper(self, i: int):
        def drop(home: int, peer_block: int) -> None:
            # the spilled copy dies unread: repay the loan, no payload moves
            self.rms[i].repay(home, peer_block)

        return drop

    # -- distkv wiring ---------------------------------------------------------

    def _heartbeat_all(self) -> None:
        for i, child in enumerate(self.children):
            self.g.heartbeat(Heartbeat(i, child.allocator.num_free,
                                       child.allocator.num_blocks))

    def _export_payload(self, child, block):
        fn = getattr(child, "export_page_payload", None)
        return fn(block) if fn is not None else None

    def _publish_hot(self, i: int) -> None:
        """Export any radix path on instance ``i`` that just crossed the hit
        threshold to the cluster board (token keys + page payloads). Pages
        the board already holds are not re-exported — payload export is a
        device->host page copy on engine children. Under zero-copy serving
        no payload is exported at all (the whole point); the physical block
        ids are published instead so peers can borrow the pages in place
        (auto publishes both, since either path may win)."""
        child = self.children[i]
        pc = child.prefix_cache
        board = self.g.prefix_board
        lend = self.share_mode != "copy"
        for tokens, blocks in pc.take_hot_paths(self.hot_threshold):
            if self.share_mode == "zero_copy":
                payloads = [None] * len(blocks)
            else:
                have = board.covered(tokens)
                payloads = [None] * have + \
                    [self._export_payload(child, b) for b in blocks[have:]]
            layout = getattr(child, "kv_layout", None)
            board.publish(i, tokens, payloads, pc.page_size,
                          blocks=blocks if lend else None,
                          schema=layout.schema if layout is not None
                          else None)

    def _make_importer(self, i: int):
        """The child scheduler's adopt-imported-pages hook: given a prompt
        and the tokens already matched locally, adopt the longest published
        extension into instance ``i``'s own radix tree."""
        child = self.children[i]

        def importer(prompt: Sequence[int], local_tokens: int) -> int:
            pc = child.prefix_cache
            pages = self.g.prefix_board.match(prompt,
                                              max_tokens=len(prompt) - 1)
            write = getattr(child, "import_page_payloads", None)
            if write is not None:
                # a real engine can only adopt pages whose KV contents were
                # published (a cost-model sim publishes payload=None — its
                # pages are bookkeeping-only and unusable here). Keep the
                # longest payload-backed prefix.
                n_ok = 0
                for page in pages:
                    if page.payload is None:
                        break
                    n_ok += 1
                pages = pages[:n_ok]
            if len(pages) * pc.page_size <= local_tokens:
                return 0  # the local tree already matches at least as far
            tokens = [t for page in pages for t in page.key]
            adopted = pc.adopt(tokens)
            if write is not None and adopted:
                write([b for _, b in adopted],
                      [pages[idx].payload for idx, _ in adopted])
            if adopted:
                if self.net is not None:
                    # payload transfer is not free: serialization + wire
                    # time per copied page (virtual children advance their
                    # clock, engines record net_time)
                    charge = getattr(child, "charge_network", None)
                    if charge is not None:
                        charge(self.net.page_copy_time(
                            len(adopted),
                            page_bytes=self._kv_page_bytes(i)))
                    m = getattr(child, "metrics", None)
                    if m is not None:
                        m.count("net_bytes",
                                self._net_bytes(i, len(adopted)))
                if self.trace is not None:
                    self.trace.instant(
                        "net", "copy", dst=i, pages=len(adopted),
                        bytes=self._net_bytes(i, len(adopted))
                        if self.net is not None else 0)
            return len(adopted)

        return importer

    def _make_remote_adopter(self, i: int):
        """The child scheduler's zero-copy hook: offer a
        :class:`~repro_torch.core.distkv.rmanager.RemoteLease` on the longest
        published single-home page chain that (a) strictly extends the
        local match, (b) has lendable block ids, and (c) the child can
        actually read (an engine needs an engine creditor's pools; a
        cost-model sim borrows from anyone — bookkeeping only). In ``auto``
        mode the NetworkModel decides borrow-vs-copy per request; declining
        here lets the copy importer run instead."""
        child = self.children[i]
        child_is_engine = hasattr(child, "k_pages")

        def adopter(req: Request, local_tokens: int):
            pc = child.prefix_cache
            pages = self.g.prefix_board.match(req.prompt,
                                              max_tokens=req.prompt_len - 1)
            usable, home = [], None
            for page in pages:
                if page.block is None:
                    break
                if home is None:
                    home = page.home
                elif page.home != home:
                    break  # one creditor per lease (one partial merge)
                usable.append(page)
            if home is None or home == i:
                return None  # nothing lendable / it lives here already
            if child_is_engine and \
                    not hasattr(self.children[home], "k_pages"):
                return None  # a sim home has no KV an engine could read
            if len(usable) * pc.page_size <= local_tokens:
                return None  # the local tree already matches at least as far
            board = self.g.prefix_board
            prior = board.lease_hits_of(i, usable)
            if self.promote_after is not None \
                    and prior >= self.promote_after \
                    and self._promote_to_copy(i, home, usable):
                return None  # prefix now lives here — serve it locally
            if self.share_mode == "auto" and not self.net.prefer_borrow(
                    len(usable), pc.page_size, req.max_new_tokens,
                    expected_reuse=prior + 1,
                    page_bytes=self._kv_page_bytes(i)):
                # copying pays off — let the importer run. The board's
                # (instance, prefix) lease hit-count is the reuse estimate:
                # the copy is paid once but amortized over the repeats this
                # prefix has already demonstrated on this instance.
                return None
            try:
                lease = self.rms[i].borrow_blocks(
                    home, [p.block for p in usable])
            except ValueError:
                return None  # stale board entry: fall back to copy/compute

            def on_commit(l):
                # fired only when an admission actually lands with the
                # lease — a failed admission releases it and must neither
                # inflate the stats nor re-charge the RPC on every retry
                self.leases_granted += 1
                self.pages_borrowed += l.num_pages
                board.record_lease(i, usable)
                if self.net is not None:
                    charge = getattr(child, "charge_network", None)
                    if charge is not None:
                        charge(self.net.lease_time(l.num_pages))
                m = getattr(child, "metrics", None)
                if m is not None:
                    m.count("borrowed_pages", l.num_pages)
                if self.trace is not None:
                    self.trace.instant("net", "lease",
                                       rid=req.request_id, debtor=i,
                                       home=l.home, pages=l.num_pages)

            lease._on_commit = on_commit
            return lease

        return adopter

    def _promote_to_copy(self, i: int, home: int, pages) -> int:
        """Promote a repeatedly-leased remote prefix to a local copy: adopt
        the chain into instance ``i``'s radix tree and fill the fresh blocks
        straight from the creditor's physical pages (board payloads are None
        under ``zero_copy`` publishing — the pages themselves are pinned, so
        they are the source of truth). One payload transfer ends the
        pay-the-merge-forever pathology; outstanding leases drain as their
        requests finish, and future admissions hit the local tree. Returns
        #pages materialized (0 = could not promote, fall back to leasing)."""
        child = self.children[i]
        home_child = self.children[home]
        write = getattr(child, "import_page_payloads", None)
        exp = getattr(home_child, "export_page_payload", None)
        if write is not None and exp is None:
            return 0  # an engine cannot materialize from a sim creditor
        pc = child.prefix_cache
        tokens = [t for page in pages for t in page.key]
        adopted = pc.adopt(tokens)
        if not adopted:
            return 0
        if write is not None:
            write([b for _, b in adopted],
                  [exp(pages[idx].block) for idx, _ in adopted])
        if self.net is not None:
            charge = getattr(child, "charge_network", None)
            if charge is not None:
                charge(self.net.page_copy_time(
                    len(adopted), page_bytes=self._kv_page_bytes(i)))
            m = getattr(child, "metrics", None)
            if m is not None:
                m.count("net_bytes", self._net_bytes(i, len(adopted)))
        self.promotions += 1
        if self.trace is not None:
            self.trace.instant("net", "promote", dst=i, home=home,
                               pages=len(adopted))
        return len(adopted)

    # -- placement -------------------------------------------------------------

    def place(self, req: Request) -> int:
        """Pick an instance for ``req`` (exposed for tests/benchmarks).
        With roles active only prefill-capable instances are candidates —
        decode-only instances receive work through the KV handoff, never
        from the front door."""
        cand = self.prefill_capable
        if len(cand) == len(self.children):
            return self.policy.choose(req, self.children)
        sub = [self.children[i] for i in cand]
        return cand[self.policy.choose(req, sub)]

    def add_request(self, req: Request) -> None:
        if req.parent_id is not None and req.parent_id in self._placement:
            # best-of-n sibling: co-locate with the parent so the child can
            # COW-fork the parent's prefill instead of prefilling again
            i = self._placement[req.parent_id]
        else:
            i = self.place(req)
        req.instance_id = i
        self._placement[req.request_id] = i
        self.requests_placed[i] += 1
        child = self.children[i]
        clk = child.clock()
        if clk is not None and clk < req.arrival_time:
            # virtual child idle in the past: it cannot serve a request
            # before the request exists
            child.advance_to(req.arrival_time)
        if self.trace is not None:
            clk = child.clock()
            self.trace.instant(
                "router", "place", rid=req.request_id,
                ts=clk if clk is not None else req.arrival_time,
                instance=i,
                policy=getattr(self.policy, "name",
                               type(self.policy).__name__))
        child.add_request(req)

    # -- ServingBackend protocol -------------------------------------------------

    @property
    def has_work(self) -> bool:
        return any(c.has_work for c in self.children)

    def clock(self) -> Optional[float]:
        if not self._virtual:
            return None
        busy = [c.clock() for c in self.children if c.has_work]
        if busy:
            return min(busy)
        return max(c.clock() for c in self.children)

    def advance_to(self, t: float) -> None:
        for c in self.children:
            if c.clock() is not None:
                c.advance_to(t)

    @property
    def iterations(self) -> int:
        return sum(getattr(c, "iterations", 0) for c in self.children)

    @property
    def preemptions(self) -> int:
        return sum(getattr(c, "preemptions", 0) for c in self.children)

    def step(self, now: Optional[float] = None) -> List[Request]:
        finished: List[Request] = []
        if self.handoff is not None:
            # prefill->decode handoffs drain before children step: a fully
            # parked prefill instance makes no progress of its own, so an
            # after-step hook would never see it
            self.handoff.drain()
        if self._virtual:
            # event-driven: advance the laggard instance that can actually
            # make progress (a stuck instance — e.g. a prompt that can never
            # fit — must not starve the others)
            order = sorted((i for i, c in enumerate(self.children)
                            if c.has_work),
                           key=lambda i: self.children[i].clock())
            for i in order:
                child = self.children[i]
                before = getattr(child, "iterations", None)
                got = child.step(now)
                finished.extend(got)
                if got or before is None or \
                        getattr(child, "iterations", None) != before:
                    self._after_step(i)
                    break
        else:
            for i, child in enumerate(self.children):
                if child.has_work:
                    finished.extend(child.step(now))
                    self._after_step(i)
        return finished

    def _after_step(self, i: int) -> None:
        if not self.prefix_share:
            return
        hits = self.children[i].prefix_cache.hit_tokens
        if hits != self._last_hits[i]:
            # only a committed admission hit can push a node over the hot
            # threshold — skip the tree walk (and gManager heartbeats) on
            # the vast majority of steps where nothing changed
            self._last_hits[i] = hits
            self._publish_hot(i)
            self._heartbeat_all()

    # -- aggregate stats ---------------------------------------------------------

    @property
    def prefix_cache(self) -> Optional[_AggregateCacheStats]:
        agg = _AggregateCacheStats()
        seen = False
        for c in self.children:
            pc = getattr(c, "prefix_cache", None)
            if pc is None:
                continue
            seen = True
            agg.hit_tokens += pc.hit_tokens
            agg.lookup_tokens += pc.lookup_tokens
            agg.num_pages += pc.num_pages
            agg.adopted_pages += pc.adopted_pages
        return agg if seen else None

    def trace_events(self):
        """All child tracers' events plus the router's own (placement,
        board, network) merged onto one timestamp-ordered timeline."""
        return merge_events(
            [getattr(c, "trace", None) for c in self.children] +
            [self.trace])

    def metrics_timelines(self) -> Dict[int, List[Dict]]:
        """Per-instance metric timelines (instance -> per-iteration rows)
        for traced children. With roles active each row is tagged with its
        instance's role, so one CSV export separates prefill iterations
        from decode iterations."""
        out: Dict[int, List[Dict]] = {}
        for i, c in enumerate(self.children):
            m = getattr(c, "metrics", None)
            if m is not None:
                rows = m.rows()
                if self.disaggregated:
                    rows = [dict(row, role=self.roles[i]) for row in rows]
                out[i] = rows
        return out

    def role_timelines(self) -> Dict[str, List[Dict]]:
        """Per-role metric split: every traced child's rows tagged with
        their instance and merged time-ordered under the instance's role.
        Under disaggregation the two shapes are the whole story — prefill
        tracks show budget-sized chunk iterations, decode tracks show small
        pure-decode iterations."""
        out: Dict[str, List[Dict]] = {}
        for i, rows in self.metrics_timelines().items():
            out.setdefault(self.roles[i], []).extend(
                dict(row, instance=i) for row in rows)
        for rows in out.values():
            rows.sort(key=lambda row: row.get("ts", 0.0))
        return out

    def instance_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-instance breakdown for ``LLMService.stats``."""
        out = {}
        for i, c in enumerate(self.children):
            row = {
                "requests": self.requests_placed[i],
                "iterations": getattr(c, "iterations", 0),
                "preemptions": getattr(c, "preemptions", 0),
                "waiting": len(c.scheduler.waiting),
                "running": len(c.scheduler.running),
                "free_pages": c.allocator.num_free,
            }
            if self.disaggregated:
                row["role"] = self.roles[i]
            pc = getattr(c, "prefix_cache", None)
            if pc is not None:
                row["prefix_hit_rate"] = pc.hit_rate
                row["cached_pages"] = pc.num_pages
                row["adopted_pages"] = pc.adopted_pages
                if self.peer_spill:
                    row["peer_spilled_pages"] = pc.peer_spilled_pages
                    row["peer_restored_pages"] = pc.peer_restored_pages
            if self.share_mode != "copy":
                # outstanding rBlock debt from the gManager ledger
                row["lent_pages"] = self.g.lent_by(i)
                row["borrowed_pages"] = self.g.borrowed_by(i)
            out[i] = row
        return out
