"""InfiniteLLM rManager: per-instance rBlock virtualization (paper §III.D.3).

Each LLM service instance owns a local :class:`BlockAllocator` and virtualizes
it behind **rBlocks** — (instance_id, physical_block) pairs with metadata. On
local exhaustion the rManager turns debtor: asks the gManager for creditor
candidates and borrows physical blocks that live on a *remote* instance.
Attention over borrowed blocks is exactly the DistAttention micro-attention
path (``dist_attention.py``): partial (m, l, o) computed where the block
lives, merged by log-sum-exp.

A copy of ``repro.core.distkv.rmanager`` with its imports changed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core.distkv.gmanager import GManager, Heartbeat
from repro_torch.core.paging.allocator import BlockAllocator, OutOfBlocks


@dataclasses.dataclass(frozen=True)
class RBlock:
    """The paper's rBlock metadata: ids + physical location."""
    rblock_id: int
    instance_id: int  # owning (home) instance of the *sequence*
    device_id: int    # instance where the physical block lives
    physical_id: int


@dataclasses.dataclass
class RemoteLease:
    """A borrowed page-aligned KV prefix: rBlocks whose physical pages live
    on a *creditor* instance and are served in place (zero-copy) through the
    DistAttention partial merge, instead of having their payloads copied.

    The debtor's scheduler holds the lease for the lifetime of the borrowing
    request; :meth:`release` repays the creditor (one ``decref`` + ledger
    repayment per block). ``acquire`` refcounts the lease so a COW-forked
    best-of-n sibling can share its parent's borrowed prefix — the creditor
    is repaid exactly once, when the last holder releases.

    Two grant sites exist: admission-time prefix adoption (lease capped at
    ``prompt_len - 1`` so the final prompt token's logits are computed
    locally) and the disaggregated KV handoff (``serving/disagg.py``),
    where the lease covers *all* full prompt pages — the prefill host
    already sampled the first token, so the decode host needs no local
    prompt KV beyond the copied partial tail page."""

    home: int                 # creditor instance the pages live on
    debtor: int
    blocks: List[int]         # physical page ids on the creditor
    page_size: int
    # KVPageLayout schema of the pages on the creditor (None = unknown,
    # sim). The installing engine validates this against its own layout —
    # attending over foreign-layout pages would read garbage.
    schema: Optional[str] = None
    _release: Optional[Callable[["RemoteLease"], None]] = None
    _on_commit: Optional[Callable[["RemoteLease"], None]] = None
    _refs: int = 1
    committed: bool = False

    @property
    def num_pages(self) -> int:
        return len(self.blocks)

    @property
    def num_tokens(self) -> int:
        return len(self.blocks) * self.page_size

    def acquire(self) -> "RemoteLease":
        if self._refs <= 0:
            raise ValueError("acquire of a released lease")
        self._refs += 1
        return self

    def commit(self) -> None:
        """Called by the scheduler when an admission actually lands with
        this lease. An adopter may be asked (and borrow) every scheduling
        retry of a request that cannot fit yet — stats/charges hooked here
        instead of at grant time count served prefixes, not retries."""
        if not self.committed:
            self.committed = True
            if self._on_commit is not None:
                self._on_commit(self)

    def release(self) -> None:
        """Repay the creditor once the last holder lets go. Idempotent past
        zero so double-release in teardown paths cannot double-repay."""
        if self._refs <= 0:
            return
        self._refs -= 1
        if self._refs == 0 and self._release is not None:
            self._release(self)


@dataclasses.dataclass
class SeqKV:
    """A sequence's logical KV: ordered rBlocks (possibly multi-instance)."""
    rblocks: List[RBlock] = dataclasses.field(default_factory=list)
    num_tokens: int = 0


class RManager:
    def __init__(self, instance_id: int, allocator: BlockAllocator,
                 gmanager: GManager):
        self.instance_id = instance_id
        self.allocator = allocator
        self.g = gmanager
        self.peers: Dict[int, "RManager"] = {}
        self._next_rblock = 0
        self.seqs: Dict[int, SeqKV] = {}
        # KVPageLayout schema of this instance's pages (None when the
        # allocator carries no layout, e.g. pure-sim backends)
        layout = getattr(allocator, "layout", None)
        self.schema: Optional[str] = layout.schema if layout is not None \
            else None
        # telemetry: this instance's Tracer (wired by the cluster router),
        # or None — emission sites guard on it
        self.trace = None
        self.heartbeat()

    def register_peers(self, peers: Dict[int, "RManager"]) -> None:
        self.peers = peers

    def heartbeat(self) -> None:
        self.g.heartbeat(Heartbeat(self.instance_id,
                                   self.allocator.num_free,
                                   self.allocator.num_blocks))

    # -- lending side -----------------------------------------------------------
    def try_lend(self, debtor: int) -> Optional[int]:
        """Allocate one local physical block on behalf of ``debtor``."""
        if self.allocator.num_free <= self.g.safety_free:
            return None
        b = self.allocator.alloc_block()
        self.g.record_loan(self.instance_id, debtor, 1)
        self.heartbeat()
        if self.trace is not None:
            self.trace.instant("lease", "lend", debtor=debtor, blocks=1,
                               kind="fresh")
        return b

    def lend_blocks(self, debtor: int, blocks: List[int]) -> None:
        """Lend *specific existing* local pages (e.g. radix-cached prefix
        pages) to ``debtor``: one extra reference per block, so neither the
        local cache's eviction nor a local ``free_table`` can return a lent
        page to the free list while the debtor reads it. Raises ValueError
        (before touching the ledger) if any block is not live."""
        for b in blocks:
            if self.allocator.refcount_of(b) == 0:
                raise ValueError(
                    f"instance {self.instance_id}: cannot lend free block "
                    f"{b} — only live pages are lendable")
        for b in blocks:
            self.allocator.incref(b)
        self.g.record_loan(self.instance_id, debtor, len(blocks))
        self.heartbeat()
        if self.trace is not None:
            self.trace.instant("lease", "lend", debtor=debtor,
                               blocks=len(blocks), kind="live")

    def repay(self, creditor: int, physical_id: int) -> None:
        self.peers[creditor].allocator.decref(physical_id)
        self.g.record_repayment(creditor, self.instance_id, 1)
        self.peers[creditor].heartbeat()
        if self.trace is not None:
            self.trace.instant("lease", "repay", creditor=creditor, blocks=1)

    # -- zero-copy prefix leases ---------------------------------------------------
    def borrow_blocks(self, home: int, blocks: List[int]) -> RemoteLease:
        """Borrow specific pages living on ``home`` as a zero-copy prefix
        lease. The lease's :meth:`RemoteLease.release` repays through this
        (debtor) rManager."""
        if home == self.instance_id:
            raise ValueError("borrowing from oneself — serve locally instead")
        lender = self.peers[home]
        if self.schema is not None and lender.schema is not None \
                and self.schema != lender.schema:
            raise ValueError(
                f"KV layout schema mismatch on lease grant: debtor instance "
                f"{self.instance_id} has layout {self.schema!r} but creditor "
                f"{home} holds {lender.schema!r} pages — refusing the "
                "zero-copy borrow (attending over foreign-layout pages "
                "would read garbage)")
        lender.lend_blocks(self.instance_id, blocks)
        if self.trace is not None:
            self.trace.instant("lease", "borrow", home=home,
                               pages=len(blocks))

        def _repay(lease: RemoteLease) -> None:
            for b in lease.blocks:
                self.repay(lease.home, b)

        return RemoteLease(home=home, debtor=self.instance_id,
                           blocks=list(blocks),
                           page_size=self.allocator.block_size,
                           schema=lender.schema,
                           _release=_repay)

    # -- borrowing side -----------------------------------------------------------
    def _alloc_one(self) -> RBlock:
        rid = self._next_rblock
        self._next_rblock += 1
        try:
            phys = self.allocator.alloc_block()
            self.heartbeat()
            return RBlock(rid, self.instance_id, self.instance_id, phys)
        except OutOfBlocks:
            pass
        # debtor path: ask the gManager for up to 3 creditors, try in order
        for cred in self.g.recommend_creditors(self.instance_id, 1):
            phys = self.peers[cred].try_lend(self.instance_id)
            if phys is not None:
                return RBlock(rid, self.instance_id, cred, phys)
        raise OutOfBlocks(f"instance {self.instance_id}: no local or remote "
                          f"blocks available")

    # -- sequence API ---------------------------------------------------------------
    def append_tokens(self, seq_id: int, new_tokens: int) -> List[RBlock]:
        """Grow a sequence; returns newly-allocated rBlocks. Atomic: if the
        cluster cannot supply all needed blocks, everything allocated so far
        is returned/repaid and OutOfBlocks propagates."""
        kv = self.seqs.setdefault(seq_id, SeqKV())
        bs = self.allocator.block_size
        total = kv.num_tokens + new_tokens
        need = -(-total // bs) - len(kv.rblocks)
        added: List[RBlock] = []
        try:
            for _ in range(need):
                rb = self._alloc_one()
                added.append(rb)
        except OutOfBlocks:
            self._return_rblocks(added)  # roll back
            self.heartbeat()
            raise
        kv.rblocks.extend(added)
        kv.num_tokens = total
        return added

    def _return_rblocks(self, rblocks: List[RBlock]) -> None:
        """Give back a set of rBlocks, **creditors first**: remote blocks
        are repaid before any local page is freed, so a fault in the local
        teardown (e.g. a double-free surfacing as ValueError mid-loop) can
        never strand a creditor's lent block — the debt side is settled by
        the time local state is touched. This is the invariant the
        debtor-preemption path relies on."""
        for rb in rblocks:
            if rb.device_id != self.instance_id:
                self.repay(rb.device_id, rb.physical_id)
        for rb in rblocks:
            if rb.device_id == self.instance_id:
                self.allocator.decref(rb.physical_id)

    def free_seq(self, seq_id: int) -> None:
        """Free a sequence's rBlocks (request finish OR preemption of a
        debtor). Remote repayments run before local frees — see
        :meth:`_return_rblocks`."""
        kv = self.seqs.pop(seq_id, None)
        if kv is None:
            return
        self._return_rblocks(kv.rblocks)
        self.heartbeat()

    # -- cross-instance prefix sharing -------------------------------------------
    def publish_prefix(self, tokens, payloads) -> int:
        """Publish a hot page-aligned prefix (token keys + page payloads)
        computed on this instance to the cluster's board (on the gManager,
        like the debt ledger). Peers adopt via :meth:`lookup_prefix` +
        ``PrefixCache.adopt``."""
        return self.g.prefix_board.publish(self.instance_id, tokens, payloads,
                                           self.allocator.block_size,
                                           schema=self.schema)

    def lookup_prefix(self, tokens, max_tokens=None):
        """Longest published page chain for ``tokens`` (any home instance)."""
        return self.g.prefix_board.match(tokens, max_tokens=max_tokens)

    # -- stats ------------------------------------------------------------------
    def remote_fraction(self, seq_id: int) -> float:
        kv = self.seqs.get(seq_id)
        if not kv or not kv.rblocks:
            return 0.0
        remote = sum(1 for rb in kv.rblocks
                     if rb.device_id != self.instance_id)
        return remote / len(kv.rblocks)
