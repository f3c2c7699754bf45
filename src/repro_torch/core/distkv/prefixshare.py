"""Cross-instance prefix publication board (InfiniteLLM-style cluster KV).

The radix prefix cache (``core.prefixcache``) shares KV pages *within* one
LLM service instance. Under a multi-instance router the same hot system
prompt is otherwise recomputed once per instance; this module is the piece
of the distkv layer that closes that gap:

* an instance whose radix tree crosses a hit-count threshold on a path
  exports ``(token keys, page payloads)`` for that path
  (:meth:`PrefixCache.take_hot_paths`) and **publishes** it here, through
  its gManager (the publication board is global-coordinator state, like the
  debt ledger);
* a peer instance, at admission time, asks the board for the longest
  published extension of its own local radix match and **adopts** those
  pages into its own tree (:meth:`PrefixCache.adopt`) — fresh local blocks
  filled from the published payloads, so the shared prefix is computed once
  cluster-wide.

Payloads are opaque to the board: the real engine publishes the per-layer
K/V page contents (host numpy, one copy per page), the cost-model simulator
publishes ``None``. The board mirrors the radix tree's shape — one node per
page, keyed by the page's token tuple — so lookup is the same page-aligned
walk. This is the *copy* flavor of cross-instance sharing; serving the
prefix remotely via borrowed rBlocks + DistAttention partial merges (no
copy, per-token remote penalty) is the recorded alternative.

Eviction. Published payloads are real memory on the coordinator (an engine
page is per-layer K/V host arrays), so the board is **size-capped**:
``max_pages`` bounds the resident page count and publishing past it evicts
least-recently-used *leaf* pages first (a leaf-only policy keeps every
surviving path intact, mirroring the radix cache's eviction). A lookup
touches every page on its matched path, so hot prefixes stay resident while
one-off publications age out. ``max_pages=None`` keeps the previous
unbounded behavior. An evicted page may still be flagged ``published`` in
its home instance's radix tree — it simply stops being adoptable (a
graceful miss) until some instance's hot path crosses the threshold again
and republishes it.

A copy of ``repro.core.distkv.prefixshare`` with its imports changed.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)


@dataclasses.dataclass
class PublishedPage:
    """One published page: token key, opaque KV payload, home instance.

    ``block`` is the physical page id on the home instance — the handle a
    peer needs to *borrow* the page (zero-copy rBlock serving) instead of
    copying its payload. ``None`` when the publisher did not offer its pages
    for lending (copy-only sharing)."""
    key: Tuple[int, ...]
    payload: Any
    home: int
    block: Optional[int] = None
    children: Dict[Tuple[int, ...], "PublishedPage"] = \
        dataclasses.field(default_factory=dict)
    parent: Optional["PublishedPage"] = None
    last_access: int = 0
    # per-borrower lease hit-count: instance id -> #times that instance has
    # served this page through a RemoteLease. The router's auto decision
    # reads it as the expected-reuse estimate (repeat traffic amortizes a
    # copy), and promote-to-copy triggers off it.
    lease_hits: Dict[int, int] = dataclasses.field(default_factory=dict)


class PrefixShareBoard:
    """Global radix of published pages. Lives on the gManager.

    ``max_pages`` caps the resident page count (LRU leaf eviction on
    publish); ``None`` = unbounded."""

    def __init__(self, max_pages: Optional[int] = None):
        self._root = PublishedPage(key=(), payload=None, home=-1)
        self.page_size: Optional[int] = None
        # KVPageLayout schema tag of every payload on this board (first
        # publisher pins it). Payloads with a different schema are refused:
        # a GQA page adopted into an MLA pool (or vice versa) would be
        # silently-reinterpreted garbage, not a graceful miss.
        self.schema: Optional[str] = None
        self.max_pages = max_pages
        # zero-copy lending hooks, set by the cluster router when borrowed
        # rBlock serving is enabled: ``on_pin(home, block)`` fires when a
        # page's home block becomes referenced by the board (the router
        # increfs it on the home allocator so neither the home's cache
        # eviction nor request teardown can free a lendable page);
        # ``on_unpin`` fires when board eviction drops the page.
        self.on_pin: Optional[Callable[[int, int], None]] = None
        self.on_unpin: Optional[Callable[[int, int], None]] = None
        self._clock = 0
        self.num_pages = 0
        # telemetry: the cluster's Tracer (wired by the router — the board
        # is coordinator state, so its events land on the router track)
        self.trace = None
        # stats
        self.published_pages = 0
        self.publications = 0
        self.lookups = 0
        self.hit_pages = 0
        self.evicted_pages = 0

    def publish(self, instance_id: int, tokens: Sequence[int],
                payloads: Sequence[Any], page_size: int,
                blocks: Optional[Sequence[int]] = None,
                schema: Optional[str] = None) -> int:
        """Publish a page-aligned path: page ``i`` holds
        ``tokens[i*ps:(i+1)*ps]`` with KV contents ``payloads[i]``.
        Pages already on the board are kept (first publisher wins — the
        payloads are equivalent by construction). ``blocks`` (optional)
        offers the publisher's physical page ids for zero-copy lending;
        each newly-recorded block is pinned via :attr:`on_pin`. ``schema``
        is the publisher's ``KVPageLayout.schema`` tag; like ``page_size``
        it must match across all publishers of one board. Returns
        #pages added."""
        if self.page_size is None:
            self.page_size = page_size
        elif self.page_size != page_size:
            raise ValueError(
                f"mixed page sizes on one board: {self.page_size} vs "
                f"{page_size} — cross-instance pages must be interchangeable")
        if schema is not None:
            if self.schema is None:
                self.schema = schema
            elif self.schema != schema:
                raise ValueError(
                    f"KV layout schema mismatch on one board: "
                    f"{self.schema!r} vs {schema!r} — refusing to publish "
                    "pages a peer with a different layout could adopt as "
                    "garbage")
        node, new = self._root, 0
        self._clock += 1
        for i in range(len(tokens) // page_size):
            key = tuple(tokens[i * page_size:(i + 1) * page_size])
            block = blocks[i] if blocks is not None else None
            child = node.children.get(key)
            if child is None:
                child = PublishedPage(key=key, payload=payloads[i],
                                      home=instance_id, parent=node)
                node.children[key] = child
                new += 1
                self.num_pages += 1
            elif child.payload is None and payloads[i] is not None:
                # a bookkeeping-only publication (sim) upgraded with real
                # page contents: engine adopters can now use the page. The
                # lendable block moves with the new home — unpin the old
                # lender's page first so its pin is returned.
                if child.block is not None and self.on_unpin is not None:
                    self.on_unpin(child.home, child.block)
                child.block = None
                child.payload = payloads[i]
                child.home = instance_id
            if block is not None and child.block is None \
                    and child.home == instance_id:
                # the home offers this page for lending: pin it so the home
                # side cannot free a block a peer may borrow
                child.block = block
                if self.on_pin is not None:
                    self.on_pin(child.home, block)
            child.last_access = self._clock
            node = child
        self.published_pages += new
        self.publications += 1
        if self.trace is not None:
            self.trace.instant("board", "publish", home=instance_id, new=new,
                               resident=self.num_pages)
        if self.max_pages is not None and self.num_pages > self.max_pages:
            self._evict(self.num_pages - self.max_pages)
        return new

    def covered(self, tokens: Sequence[int]) -> int:
        """#leading pages of ``tokens`` already on the board *with a
        payload* (stat-free). Publishers skip exporting those — payload
        export is a device->host page copy on engines — but still supply
        payloads for payload-less pages so a bookkeeping-only (sim)
        publication gets upgraded."""
        if self.page_size is None:
            return 0
        ps = self.page_size
        node, n = self._root, 0
        for i in range(len(tokens) // ps):
            node = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if node is None or node.payload is None:
                break
            n += 1
        return n

    def match(self, tokens: Sequence[int], *,
              max_tokens: Optional[int] = None) -> List[PublishedPage]:
        """Longest published page chain prefixing ``tokens`` (may be empty)."""
        if self.page_size is None:
            return []
        ps = self.page_size
        limit = len(tokens) if max_tokens is None else \
            min(max_tokens, len(tokens))
        node, path = self._root, []
        self._clock += 1
        for i in range(limit // ps):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            child.last_access = self._clock
            path.append(child)
            node = child
        self.lookups += 1
        self.hit_pages += len(path)
        if self.trace is not None:
            self.trace.instant("board", "lookup", hit_pages=len(path))
        return path

    def record_lease(self, instance_id: int,
                     pages: Sequence[PublishedPage]) -> int:
        """Count one committed lease by ``instance_id`` over ``pages``.

        Returns the updated hit-count of the *deepest* page — the value the
        router uses as the (instance, prefix) reuse estimate, since the
        deepest page identifies the full leased prefix."""
        n = 0
        for page in pages:
            n = page.lease_hits.get(instance_id, 0) + 1
            page.lease_hits[instance_id] = n
        if self.trace is not None:
            self.trace.instant("board", "lease_hit", instance=instance_id,
                               pages=len(pages), hits=n)
        return n

    def lease_hits_of(self, instance_id: int,
                      pages: Sequence[PublishedPage]) -> int:
        """Prior lease count of ``instance_id`` on a matched chain (the
        deepest page's count — 0 if the chain is empty or never leased)."""
        if not pages:
            return 0
        return pages[-1].lease_hits.get(instance_id, 0)

    # -- eviction ---------------------------------------------------------------
    def _evict(self, n: int) -> int:
        """Drop ``n`` least-recently-used leaf pages (payloads freed with
        them). Leaf-only eviction keeps every surviving root path intact;
        evicting a leaf can expose its parent as the new oldest leaf, so a
        min-heap over the dynamic leaf set implements strict LRU — a cold
        path ages out tail-first until it is gone — in one tree walk plus
        O(log) per drop, not a walk per dropped page."""
        heap: List[Tuple[int, int, PublishedPage]] = []
        seq = 0  # heap tiebreak: PublishedPage is not orderable
        stack = [self._root]
        while stack:
            node = stack.pop()
            for ch in node.children.values():
                if ch.children:
                    stack.append(ch)
                else:
                    heap.append((ch.last_access, seq, ch))
                    seq += 1
        heapq.heapify(heap)
        dropped = 0
        while dropped < n and heap:
            _, _, leaf = heapq.heappop(heap)
            parent = leaf.parent
            del parent.children[leaf.key]
            leaf.parent = None
            if leaf.block is not None and self.on_unpin is not None:
                # return the lending pin: the home may free the page again
                # (outstanding leases hold their own references)
                self.on_unpin(leaf.home, leaf.block)
            self.num_pages -= 1
            dropped += 1
            if parent is not self._root and not parent.children:
                heapq.heappush(heap, (parent.last_access, seq, parent))
                seq += 1
        self.evicted_pages += dropped
        if self.trace is not None:
            self.trace.instant("board", "evict", dropped=dropped,
                               resident=self.num_pages)
        return dropped

    def stats(self) -> Dict[str, int]:
        return {
            "published_pages": self.published_pages,
            "publications": self.publications,
            "lookups": self.lookups,
            "hit_pages": self.hit_pages,
            "resident_pages": self.num_pages,
            "evicted_pages": self.evicted_pages,
        }
