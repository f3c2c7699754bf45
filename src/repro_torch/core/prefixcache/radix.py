"""Radix-tree prefix KV cache: cross-request sharing of physical pages.

DESIGN
======

Problem. The paging layer (``core.paging.allocator``) shares pages only
*within* a fork family (parallel sampling COW) and every admitted prompt is
prefilled from token 0. Production traffic is dominated by shared prefixes —
system prompts, few-shot templates, multi-turn chat history — so the same
prefix KV is recomputed and stored once per request.

Solution. A token-keyed radix tree over **physical KV pages**. Each node owns
exactly one full page: its key is the ``page_size``-token tuple stored in that
page, its value the physical block id. A root-to-node path therefore spells a
page-aligned token prefix, and the blocks along the path are precisely the KV
pages a new request with that prefix can reuse. The tree *holds one allocator
reference per adopted block* (``incref``), so pages survive the freeing of the
request that produced them; refcounts make sharing safe with the existing COW
machinery (a cached page always has refcount >= 1 from the tree, so any
appender that lands inside it copies first).

Lifecycle per request:

1. **match** — at admission the scheduler walks the tree over the prompt's
   full pages (capped at ``prompt_len - 1`` tokens so at least one suffix
   token remains to produce logits). Pure lookup, no side effects.
2. **lock** — once admission commits, the matched path is pinned
   (``pin_count``) and each block increfed on behalf of the request; the
   blocks seed the request's :class:`BlockTable`, so the uniform
   ``free_table`` path works unchanged at the end of life.
3. **insert** — as soon as the request's prefill iteration completes, its
   full *prompt* pages are inserted (their KV now exists, so waiting for
   request completion would let a same-prefix burst recompute the prefix N
   times): pages already present are skipped (the request's copy is simply
   freed at end of life), new pages are adopted by the tree with an extra
   reference.
4. **evict** — under ``OutOfBlocks`` pressure the scheduler evicts
   least-recently-used *unpinned leaves* before resorting to preemption.
   Only pages the tree exclusively owns (allocator refcount 1) are
   candidates: a page a running request still references is never freed, and
   forgetting it would lose cache without reclaiming memory.

Token-level matching (SGLang-style splitting, page-granular). SGLang's radix
tree is *token-level*: nodes hold variable-length token runs and are split on
partial matches, so a hit can end mid-page. Nodes here keep the 1:1
node/block mapping (one node == one full physical page), but the *frontier*
of a match is token-level: after the longest full-page walk,
:meth:`match_partial` scans the last node's children for the one sharing the
longest token run with the prompt's next page — up to ``page_size - 1``
further cached tokens. The "split" is realized at admission as a
**partial-page COW** instead of a tree mutation: the scheduler locks the
partially-matched node into the request's block table with only the shared
run counted as stored tokens, and the allocator's existing copy-on-write
duplicates the physical page on the first suffix write (the node stays
intact for requests continuing down its own branch). When the new request's
prefill completes, its divergent boundary page is inserted as a sibling —
the tree then holds both post-split branches, each backed by its own full
page, which is exactly SGLang's post-split structure expressed in whole
pages. Token-level matching is on by default (``token_level=False`` restores
page-aligned-only hits).
Cross-instance sharing. Every node carries a **hit counter** (bumped once
per *committed* admission that reuses the node — neither routing-policy
``probe`` lookups nor failed admission retries count). A serving router can ask for the *hot* root paths
(:meth:`take_hot_paths`) to publish their token keys + page payloads through
the distkv layer, and a peer instance adopts a published path into its own
tree with :meth:`adopt` — fresh local blocks, tree-owned, so the peer serves
the shared system prompt without ever computing it. The tree itself is
**payload-agnostic**: it tracks block *ids* and token keys only, never page
contents or their shape, so it works unchanged over any
:class:`~repro_torch.core.paging.layout.KVPageLayout` (full GQA K/V pages and
MLA latent ckv/krope pages alike) — payload movement lives entirely in the
spill/publish/adopt hooks its owner wires, and the schema-compatibility
check between instances lives on the share board and lease grants.

Spill-to-host (tiered cache). With ``spill_budget > 0`` and a host tier on
the allocator, a cold leaf under eviction pressure *spills* to a host page
instead of being dropped: its device page is freed (what eviction wanted)
but the KV survives on host, the node stays in the tree with ``block = -1``
and ``host_block`` set, and a later :meth:`match` walking onto it *restores*
it onto a fresh device block (the ``spill_out_fn`` / ``spill_in_fn`` hooks
move the payloads; the sim leaves them None). The host budget is bounded and
LRU: when full, the coldest spilled page is dropped for good. Spilled nodes
are always leaves (insert un-spills in place before growing through one),
probe lookups still count them as hits, and hot-path publication skips them.

The LRU clock is a logical counter (no wall time), keeping the simulator
deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.paging.allocator import BlockAllocator, OutOfBlocks


@dataclasses.dataclass
class RadixNode:
    """One cached physical page. ``key`` is the page's token content."""
    key: Tuple[int, ...]
    block: int
    parent: Optional["RadixNode"]
    children: Dict[Tuple[int, ...], "RadixNode"] = \
        dataclasses.field(default_factory=dict)
    last_access: int = 0
    pin_count: int = 0  # running requests currently holding this node
    hit_count: int = 0  # committed admissions that reused this node
    published: bool = False  # already exported for cross-instance sharing
    pending_hot: bool = False  # queued in _recent_hits awaiting publication
    # spill-to-host: when spilled, ``block`` is -1 and this holds the host
    # page keeping the KV alive (-1 = device-resident)
    host_block: int = -1
    # spill-to-peer: the KV lives in a *neighbor instance's* device page
    # (lent rBlock) instead of host — ``block`` is -1, ``host_block`` is -1,
    # and these name the creditor instance and its physical page
    peer_home: int = -1
    peer_block: int = -1


class PrefixCache:
    def __init__(self, allocator: BlockAllocator,
                 page_size: Optional[int] = None, *,
                 token_level: bool = True,
                 spill_budget: int = 0):
        self.allocator = allocator
        self.page_size = page_size or allocator.block_size
        # token-level frontier matching (SGLang-style): recover up to
        # page_size - 1 tokens per hit past the last full-page match
        self.token_level = token_level
        self.root = RadixNode(key=(), block=-1, parent=None)
        self._clock = 0
        self.num_pages = 0
        # admission stats (recorded by the scheduler via record_admission)
        self.lookup_tokens = 0
        self.hit_tokens = 0
        self.admissions = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.adopted_pages = 0  # pages imported from a peer's publication
        # hot-path publication plumbing, enabled by a cluster router
        # (track_hot=True). Off by default: a single-instance cache must not
        # accumulate node references nobody will ever drain.
        self.track_hot = False
        # nodes whose hit_count moved since the last take_hot_paths drain:
        # publication scans O(recently-hit) nodes, never the whole tree
        self._recent_hits: List[RadixNode] = []
        # spill-to-host: max host pages this cache may hold (0 = classic
        # hard eviction), the nodes currently spilled, and the payload
        # movers (same (dev, host)-pair-list signature as the scheduler's
        # swap hooks; the engine wires them, the sim has no payloads)
        self.spill_budget = spill_budget
        self._spilled: List[RadixNode] = []
        self.spill_out_fn = None
        self.spill_in_fn = None
        self.spilled_pages = 0   # cumulative spill-outs
        self.restored_pages = 0  # cumulative spill-ins (restores)
        # spill-to-peer tier (wired by a cluster router over the rBlock
        # lend/borrow machinery; None = host tier only). Tried *before*
        # host: a neighbor's free device memory restores over the NVLink
        # lane instead of PCIe.
        #   peer_spill_fn(dev_block) -> Optional[(home_instance, peer_block)]
        #     copies the payload out while dev_block is still allocated
        #   peer_restore_fn(home, peer_block, dev_block)
        #     copies back onto a fresh local block and repays the loan
        #   peer_drop_fn(home, peer_block)
        #     repays the loan without copying (page dies)
        self.peer_spill_fn = None
        self.peer_restore_fn = None
        self.peer_drop_fn = None
        self.peer_spilled_pages = 0
        self.peer_restored_pages = 0

    # -- lookup -----------------------------------------------------------------
    def match(self, tokens: Sequence[int], *,
              max_tokens: Optional[int] = None,
              probe: bool = False) -> List[RadixNode]:
        """Longest page-aligned cached prefix of ``tokens``.

        Returns the matched node path (root excluded; may be empty). Pure
        lookup apart from LRU touching — callers commit with :meth:`lock`,
        and hit counters (which drive cross-instance publication) are only
        bumped by :meth:`record_admission` on a *committed* admission, so a
        request retrying admission under memory pressure cannot inflate
        them. ``max_tokens`` caps the match (admission passes
        ``prompt_len - 1`` so a fully-cached prompt still prefills its last
        token for logits). ``probe=True`` is fully side-effect-free for
        routing policies probing every instance."""
        ps = self.page_size
        limit = len(tokens) if max_tokens is None else \
            min(max_tokens, len(tokens))
        node, path = self.root, []
        if not probe:
            self._clock += 1
        for i in range(limit // ps):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            if child.block == -1:
                # spilled page: a probe counts it as a hit without touching
                # anything; a committing match restores it onto a fresh
                # device block (or stops the path when the device is full —
                # the prefix restored so far is still valid)
                if not probe and not self._restore(child):
                    break
            if not probe:
                child.last_access = self._clock
            path.append(child)
            node = child
        return path

    def _restore(self, node: RadixNode) -> bool:
        """Spill-in: re-materialize a spilled node onto a device block
        (from the peer tier or the host tier, wherever it lives)."""
        try:
            dev = self.allocator.alloc_block()
        except OutOfBlocks:
            return False
        if node.peer_block != -1:
            self.peer_restore_fn(node.peer_home, node.peer_block, dev)
            node.peer_home = node.peer_block = -1
            self.peer_restored_pages += 1
        else:
            if self.spill_in_fn is not None:
                self.spill_in_fn([(node.host_block, dev)])
            self.allocator.free_host_block(node.host_block)
            node.host_block = -1
        self._spilled.remove(node)
        node.block = dev
        self.restored_pages += 1
        return True

    def match_partial(self, tokens: Sequence[int],
                      path: List[RadixNode], *,
                      max_tokens: Optional[int] = None,
                      probe: bool = False
                      ) -> Optional[Tuple[RadixNode, int]]:
        """Token-level frontier of a full-page :meth:`match`: the child of
        the last matched node sharing the longest run of further tokens.

        Returns ``(node, n_tokens)`` with ``1 <= n_tokens < page_size`` or
        ``None``. The caller reuses the node's page for its first
        ``n_tokens`` only — locking it into a block table with a partial
        token count makes the allocator COW the page on the first suffix
        write (the split-boundary copy), leaving the node's own branch
        intact. Disabled with ``token_level=False``."""
        if not self.token_level:
            return None
        ps = self.page_size
        limit = len(tokens) if max_tokens is None else \
            min(max_tokens, len(tokens))
        done = len(path) * ps
        rest = tokens[done:limit]
        if not rest:
            return None
        node = path[-1] if path else self.root
        best, best_run = None, 0
        for key, child in node.children.items():
            if child.block == -1:
                continue  # spilled: no device page to COW-lock
            run = 0
            stop = min(len(rest), len(key))
            while run < stop and key[run] == rest[run]:
                run += 1
            if run > best_run:
                best, best_run = child, run
        if best is None or best_run >= ps:
            # a full-page run would have been consumed by match() already;
            # >= ps here would mean an inconsistent tree
            return None
        if not probe:
            best.last_access = self._clock
        return best, best_run

    # -- request lifecycle --------------------------------------------------------
    def lock(self, path: List[RadixNode]) -> List[int]:
        """Pin ``path`` and take one block reference per node on behalf of an
        admitted request. Returns the block ids (in prefix order) for seeding
        the request's block table; ``free_table`` releases the references."""
        for node in path:
            node.pin_count += 1
            self.allocator.incref(node.block)
        return [node.block for node in path]

    def release(self, path: List[RadixNode]) -> None:
        """Unpin a path locked at admission (block refs are returned
        separately by the request's ``free_table``)."""
        for node in path:
            node.pin_count -= 1

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Insert the full pages of ``tokens`` (page ``i`` backed by
        ``blocks[i]``). Pages already cached are skipped; new pages are
        adopted with an extra allocator reference. Returns #pages adopted."""
        ps = self.page_size
        node, new = self.root, 0
        self._clock += 1
        for i in range(len(tokens) // ps):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                self.allocator.incref(blocks[i])
                child = RadixNode(key=key, block=blocks[i], parent=node)
                node.children[key] = child
                self.num_pages += 1
                new += 1
            elif child.block == -1:
                # un-spill in place for free: the inserter just computed
                # this very page, so adopt its fresh device block and let
                # the stale spilled copy go. Also keeps spilled nodes
                # leaves — we never grow a branch through an off-device
                # page.
                self.allocator.incref(blocks[i])
                if child.peer_block != -1:
                    if self.peer_drop_fn is not None:
                        self.peer_drop_fn(child.peer_home, child.peer_block)
                    child.peer_home = child.peer_block = -1
                else:
                    self.allocator.free_host_block(child.host_block)
                    child.host_block = -1
                self._spilled.remove(child)
                child.block = blocks[i]
            child.last_access = self._clock
            node = child
        self.inserted_pages += new
        return new

    # -- cross-instance sharing ---------------------------------------------------
    def take_hot_paths(self, threshold: int
                       ) -> List[Tuple[Tuple[int, ...], List[int]]]:
        """Root paths ending at *hot* nodes (``hit_count >= threshold``) not
        yet published. Each entry is ``(token_prefix, blocks)`` — the full
        token key of the path and the physical page per node — ready to be
        shipped (with page payloads) to the distkv publication board. Nodes
        are marked ``published`` so a path is exported once; the union of
        exported paths is the tree's hot subtree.

        Cost is O(recently-hit nodes), not O(tree): ``record_admission``
        queues the nodes it bumps and this drains the queue (nodes still
        under the threshold re-queue on their next hit)."""
        out = []
        for node in self._recent_hits:
            node.pending_hot = False
            if node.hit_count < threshold or node.published or \
                    node.parent is None:  # parent None = evicted meanwhile
                continue
            node.published = True
            toks: List[int] = []
            blocks: List[int] = []
            walk = node
            while walk.parent is not None:  # ancestors of a live node live
                if walk.block == -1:
                    break  # spilled since the hit: no payload to publish
                toks[:0] = walk.key
                blocks.insert(0, walk.block)
                walk = walk.parent
            if walk.parent is not None:
                node.published = False  # republishable once restored
                continue
            out.append((tuple(toks), blocks))
        self._recent_hits.clear()
        return out

    def adopt(self, tokens: Sequence[int]) -> List[Tuple[int, int]]:
        """Adopt a *published* page chain computed on another instance:
        allocate one fresh local block per page of ``tokens`` not already
        cached and graft the nodes into the tree (tree-owned, refcount 1).

        Returns ``(page_index, block)`` for every newly adopted page — the
        caller must materialize the page payloads (KV contents) into those
        blocks before any request reads them. Adoption is best-effort: it
        stops at the first page the allocator cannot supply (the leading
        pages alone are still a valid prefix). Imported nodes keep
        ``published=True`` so an adopter never re-publishes a prefix it did
        not compute."""
        ps = self.page_size
        node, adopted = self.root, []
        self._clock += 1
        for i in range(len(tokens) // ps):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is not None and child.block == -1:
                break  # adoption stops at a spilled frontier (a later
                # match restores it; growing through it would put children
                # under a host-resident page)
            if child is None:
                try:
                    block = self.allocator.alloc_block()
                except OutOfBlocks:  # keep the prefix adopted so far
                    break
                child = RadixNode(key=key, block=block, parent=node,
                                  published=True)
                node.children[key] = child
                self.num_pages += 1
                adopted.append((i, block))
            child.last_access = self._clock
            node = child
        self.adopted_pages += len(adopted)
        return adopted

    # -- eviction -----------------------------------------------------------------
    def evict(self, n_blocks: int, *, spill: bool = True) -> int:
        """Return >= ``n_blocks`` pages to the allocator's free list by
        dropping LRU unpinned leaves. Only pages the tree *exclusively* owns
        (refcount 1) are candidates: a page some request still references is
        never freed, and dropping the tree's reference to it would destroy
        cache without reclaiming any memory. With a spill budget, a
        candidate's KV moves to a host page instead of dying (the device
        page is freed either way). Returns blocks actually freed."""
        freed = 0
        progress = True
        # one tree walk per pass, not per freed block; extra passes only when
        # evicting a leaf exposes its parent as a new eviction candidate
        while freed < n_blocks and progress:
            progress = False
            for leaf in self._lru_leaves():
                if freed >= n_blocks:
                    break
                if spill and self.spill_budget and self._spill(leaf):
                    freed += 1  # device page freed, KV kept on host
                    progress = True
                    continue
                before = self.allocator.num_free
                self.allocator.decref(leaf.block)
                freed += self.allocator.num_free - before
                del leaf.parent.children[leaf.key]
                leaf.parent = None  # take_hot_paths skips evicted nodes
                self.num_pages -= 1
                self.evicted_pages += 1
                progress = True
        return freed

    def _spill(self, leaf: RadixNode) -> bool:
        """Move a cold leaf's page off-device: a neighbor instance's free
        device memory first (NVLink lane), the host tier second (PCIe).
        Falls back to False (hard eviction) when neither can take it."""
        if len(self._spilled) >= self.spill_budget:
            # budget full: the coldest spilled page dies so this (more
            # recently used) one can take its slot
            self._drop_spilled(min(self._spilled,
                                   key=lambda n: n.last_access))
        if self.peer_spill_fn is not None:
            # the fn copies the payload while leaf.block is still allocated
            dst = self.peer_spill_fn(leaf.block)
            if dst is not None:
                leaf.peer_home, leaf.peer_block = dst
                self.allocator.decref(leaf.block)  # refcount 1 -> freed
                leaf.block = -1
                self._spilled.append(leaf)
                self.spilled_pages += 1
                self.peer_spilled_pages += 1
                return True
        if self.allocator.host_num_free == 0:
            return False  # host pool exhausted (table swaps hold it)
        host = self.allocator.alloc_host_block()
        if self.spill_out_fn is not None:
            self.spill_out_fn([(leaf.block, host)])
        self.allocator.decref(leaf.block)  # refcount 1 -> page freed
        leaf.host_block = host
        leaf.block = -1
        self._spilled.append(leaf)
        self.spilled_pages += 1
        return True

    def _drop_spilled(self, node: RadixNode) -> None:
        """Permanently drop a spilled node (its peer loan repaid or host
        page freed, node unlinked). Spilled nodes are always leaves —
        nothing dangles."""
        if node.peer_block != -1:
            if self.peer_drop_fn is not None:
                self.peer_drop_fn(node.peer_home, node.peer_block)
            node.peer_home = node.peer_block = -1
        else:
            self.allocator.free_host_block(node.host_block)
        del node.parent.children[node.key]
        node.parent = None
        self._spilled.remove(node)
        self.num_pages -= 1
        self.evicted_pages += 1

    def _lru_leaves(self) -> List[RadixNode]:
        """Unpinned, exclusively-tree-owned leaves, oldest first."""
        leaves = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for ch in node.children.values():
                if ch.children:
                    stack.append(ch)
                elif ch.pin_count == 0 and \
                        self.allocator.refcount_of(ch.block) == 1:
                    leaves.append(ch)
        leaves.sort(key=lambda ch: ch.last_access)
        return leaves

    def clear(self) -> int:
        """Drop every unpinned page (e.g. on engine reset), host tier
        included — no spilling on the way out."""
        for node in list(self._spilled):
            self._drop_spilled(node)
        return self.evict(self.num_pages, spill=False)

    # -- stats --------------------------------------------------------------------
    def record_admission(self, prompt_tokens: int, hit_tokens: int,
                         path: Sequence[RadixNode] = ()) -> None:
        """Called once per *committed* admission. ``path`` is the locked
        node chain the request reuses; its hit counters feed hot-path
        publication (one bump per serving request, never per retry)."""
        self.admissions += 1
        self.lookup_tokens += prompt_tokens
        self.hit_tokens += hit_tokens
        for node in path:
            node.hit_count += 1
            if self.track_hot and not node.published \
                    and not node.pending_hot:
                node.pending_hot = True
                self._recent_hits.append(node)

    @property
    def hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from cached pages."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0

    @property
    def cached_tokens(self) -> int:
        return self.num_pages * self.page_size

    def stats(self) -> Dict[str, float]:
        return {
            "hit_rate": self.hit_rate,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "admissions": self.admissions,
            "cached_pages": self.num_pages,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "adopted_pages": self.adopted_pages,
            "spilled_pages": self.spilled_pages,
            "restored_pages": self.restored_pages,
            "spilled_now": len(self._spilled),
            "peer_spilled_pages": self.peer_spilled_pages,
            "peer_restored_pages": self.peer_restored_pages,
        }
