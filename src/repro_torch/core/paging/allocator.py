"""vLLM-style block allocator (paper §III.C): free list + refcounts + COW.

Physical KV pages are fixed-size blocks; sequences map logical→physical via a
block table. Reference counting enables parallel-sampling / beam-search
sharing: forked sequences share prompt pages until a write triggers
copy-on-write. Utilization statistics feed the paper's "ORCA uses only
20.4–38.2% of KV memory" comparison (benchmarks/kv_utilization.py).

Host swap tier. With ``host_blocks > 0`` the allocator also tracks a pool of
host-memory pages so preemption can *swap* a victim's KV out over PCIe
instead of sacrificing it to recompute: :meth:`swap_out` moves a table's
device pages to host blocks (device refs dropped — pages a radix tree or a
fork sibling still references survive on device for those holders; the host
copy is this table's private snapshot) and :meth:`swap_in` re-materializes
them onto fresh device blocks. The bookkeeping distinguishes *swapped* from
*freed*: ``swapped_pages`` counts host blocks in use, ``num_free`` never
includes them, and a table is either device-resident (``blocks``) or
host-resident (``host_blocks``) — never both. The data movement itself is the
execution backend's job (the engine copies page payloads, the simulator
charges PCIe time); the allocator only keeps the ledgers honest.

Pending-out ledger (overlapped swaps). A synchronous :meth:`swap_out` frees
device pages in the same scheduling step the copy is issued, which forces the
backend to complete the DMA before compute. The split
:meth:`swap_out_issue` / :meth:`swap_out_complete` /
:meth:`swap_out_cancel` API lets a *speculative* swap-out overlap the next
iteration's compute: issue moves the table's device references into an
in-flight ledger (the pages stay allocated — ``num_free`` does NOT grow — so
nothing can reallocate-and-clobber a DMA source mid-flight), complete drops
those references one iteration later (pages free then, exactly as a
synchronous swap-out would have left them), and cancel puts the references
back on the table and releases the host blocks (the pages never left).
Conservation holds throughout: ``num_used + num_free == num_blocks`` with
in-flight pages counted used, and ``pending_out_pages`` exposes the
in-flight count for invariant checks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


class OutOfBlocks(Exception):
    pass


class OutOfHostBlocks(Exception):
    pass


@dataclasses.dataclass
class BlockTable:
    """Logical pages (in order) -> physical block ids for one sequence.

    While swapped out, ``blocks`` is empty and ``host_blocks`` holds the
    host-tier page per logical page (same order); ``num_tokens`` is
    unchanged — the tokens still exist, just not on device."""
    blocks: List[int] = dataclasses.field(default_factory=list)
    num_tokens: int = 0  # tokens actually stored
    host_blocks: List[int] = dataclasses.field(default_factory=list)

    def capacity(self, block_size: int) -> int:
        return len(self.blocks) * block_size

    @property
    def on_host(self) -> bool:
        return bool(self.host_blocks)


class BlockAllocator:
    def __init__(self, num_blocks: int, block_size: int,
                 host_blocks: int = 0, layout=None):
        self.num_blocks = num_blocks
        self.block_size = block_size
        # the KVPageLayout whose pages these blocks index (None = unknown,
        # e.g. pure-sim backends); cost models read ``page_bytes`` off it
        self.layout = layout
        self.free_list: List[int] = list(range(num_blocks - 1, -1, -1))
        self.refcount: Dict[int, int] = {}
        # host swap tier (0 = disabled): host pages are snapshots owned by
        # exactly one table or spilled cache node, so a plain free list
        # suffices — no refcounts, no COW
        self.num_host_blocks = host_blocks
        self.host_free_list: List[int] = list(range(host_blocks - 1, -1, -1))
        # in-flight swap-outs: ticket -> (device, host) pairs whose device
        # references the ledger owns until complete/cancel resolves them
        self._pending_out: Dict[int, List[Tuple[int, int]]] = {}
        self._pending_seq = 0
        self.pending_out_pages = 0

    @property
    def page_bytes(self) -> Optional[int]:
        """Serialized bytes of one page, from the layout (None if unknown)."""
        if self.layout is None:
            return None
        return self.layout.page_bytes(self.block_size)

    # -- raw blocks -----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self.free_list)

    @property
    def num_used(self) -> int:
        return self.num_blocks - self.num_free

    def alloc_block(self) -> int:
        if not self.free_list:
            raise OutOfBlocks
        b = self.free_list.pop()
        self.refcount[b] = 1
        return b

    def incref(self, block: int) -> None:
        if block not in self.refcount:
            raise ValueError(
                f"incref of unallocated block {block} (free or never "
                f"allocated) — references may only be added to live blocks")
        self.refcount[block] += 1

    def decref(self, block: int) -> None:
        if block not in self.refcount:
            raise ValueError(
                f"decref of unallocated block {block} — double free or "
                f"unknown block")
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            del self.refcount[block]
            self.free_list.append(block)

    def refcount_of(self, block: int) -> int:
        """Live reference count of ``block`` (0 = free / never allocated)."""
        return self.refcount.get(block, 0)

    # -- host swap tier ---------------------------------------------------------
    @property
    def host_num_free(self) -> int:
        return len(self.host_free_list)

    @property
    def swapped_pages(self) -> int:
        """Host pages in use (swapped-out tables + spilled cache pages)."""
        return self.num_host_blocks - len(self.host_free_list)

    def alloc_host_block(self) -> int:
        if not self.host_free_list:
            raise OutOfHostBlocks
        return self.host_free_list.pop()

    def free_host_block(self, block: int) -> None:
        if block in self.host_free_list or not \
                (0 <= block < self.num_host_blocks):
            raise ValueError(f"free of host block {block} that is not live "
                             f"— double free or unknown block")
        self.host_free_list.append(block)

    def can_swap_out(self, table: BlockTable) -> bool:
        return not table.on_host and \
            len(table.blocks) <= len(self.host_free_list)

    def swap_out(self, table: BlockTable) -> List[Tuple[int, int]]:
        """Move ``table``'s pages device -> host. Returns ``(device, host)``
        pairs — the execution backend must copy each device page's payload
        into its host page BEFORE any same-iteration write can touch a
        reallocated device block (the scheduler orders swap-out copies
        first). Device refs are dropped (a tree-shared page survives on
        device for its other holders; the host copy is this table's private
        snapshot), so ``num_free`` grows by the exclusively-owned pages."""
        if table.on_host:
            raise ValueError("swap_out of an already-swapped table")
        if len(table.blocks) > len(self.host_free_list):
            raise OutOfHostBlocks
        pairs = []
        for dev in table.blocks:
            host = self.alloc_host_block()
            pairs.append((dev, host))
            table.host_blocks.append(host)
            self.decref(dev)
        table.blocks.clear()
        return pairs

    def swap_out_issue(self, table: BlockTable
                       ) -> Tuple[int, List[Tuple[int, int]]]:
        """Start an overlapped swap-out: allocate host pages and move the
        table's device references into the pending ledger WITHOUT freeing
        them — the DMA sources stay allocated until
        :meth:`swap_out_complete` so no same- or next-iteration write can
        land on them. Returns ``(ticket, (device, host) pairs)``; the table
        is host-resident immediately (``blocks`` empty, ``host_blocks``
        set), exactly as after a synchronous :meth:`swap_out`."""
        if table.on_host:
            raise ValueError("swap_out of an already-swapped table")
        if len(table.blocks) > len(self.host_free_list):
            raise OutOfHostBlocks
        pairs = []
        for dev in table.blocks:
            host = self.alloc_host_block()
            pairs.append((dev, host))
            table.host_blocks.append(host)
        table.blocks.clear()  # the ledger owns the device refs now
        ticket = self._pending_seq
        self._pending_seq += 1
        self._pending_out[ticket] = pairs
        self.pending_out_pages += len(pairs)
        return ticket, pairs

    def swap_out_complete(self, ticket: int) -> List[Tuple[int, int]]:
        """Resolve an issued swap-out: the copy landed, drop the ledger's
        device references (pages free now for exclusive owners; tree-shared
        pages survive for their other holders)."""
        pairs = self._pending_out.pop(ticket)
        self.pending_out_pages -= len(pairs)
        for dev, _ in pairs:
            self.decref(dev)
        return pairs

    def swap_out_cancel(self, ticket: int, table: BlockTable
                        ) -> List[Tuple[int, int]]:
        """Abort an issued swap-out: pressure receded before the copy was
        needed. Device references move back onto ``table`` (the pages never
        left — no payload was lost) and the host pages are released."""
        pairs = self._pending_out.pop(ticket)
        self.pending_out_pages -= len(pairs)
        table.blocks.extend(dev for dev, _ in pairs)
        for _, host in pairs:
            self.free_host_block(host)
        table.host_blocks.clear()
        return pairs

    def can_swap_in(self, table: BlockTable) -> bool:
        return table.on_host and len(table.host_blocks) <= self.num_free

    def swap_in(self, table: BlockTable) -> List[Tuple[int, int]]:
        """Move ``table``'s pages host -> device onto fresh blocks. Returns
        ``(host, device)`` pairs for the backend's copies; host pages are
        released (their snapshot is consumed). Raises OutOfBlocks with the
        table untouched when the device pool cannot supply every page."""
        if not table.on_host:
            raise ValueError("swap_in of a device-resident table")
        if len(table.host_blocks) > self.num_free:
            raise OutOfBlocks
        pairs = []
        for host in table.host_blocks:
            dev = self.alloc_block()
            pairs.append((host, dev))
            table.blocks.append(dev)
            self.free_host_block(host)
        table.host_blocks.clear()
        return pairs

    # -- sequence-level API ----------------------------------------------------
    def blocks_needed(self, table: BlockTable, new_tokens: int) -> int:
        total = table.num_tokens + new_tokens
        need = -(-total // self.block_size)  # ceil
        return max(0, need - len(table.blocks))

    def can_append(self, table: BlockTable, new_tokens: int) -> bool:
        return self.blocks_needed(table, new_tokens) <= self.num_free

    def append_tokens(self, table: BlockTable,
                      new_tokens: int) -> List[Tuple[int, int]]:
        """Grow ``table`` to hold ``new_tokens`` more tokens, applying COW to
        the tail block if it is shared. Returns the ``(old, new)`` block
        pairs of any copy-on-write replacement — the engine must copy the
        old physical page's contents into the new page before writing."""
        cow: List[Tuple[int, int]] = []
        if new_tokens <= 0:
            return cow
        # copy-on-write: the block being written must be exclusively owned
        if table.blocks and table.num_tokens % self.block_size != 0:
            tail = table.blocks[-1]
            if self.refcount[tail] > 1:
                fresh = self.alloc_block()
                self.decref(tail)
                table.blocks[-1] = fresh
                cow.append((tail, fresh))
        for _ in range(self.blocks_needed(table, new_tokens)):
            table.blocks.append(self.alloc_block())
        table.num_tokens += new_tokens
        return cow

    def fork(self, table: BlockTable) -> BlockTable:
        """Share all pages (parallel sampling / beam search)."""
        for b in table.blocks:
            self.incref(b)
        return BlockTable(blocks=list(table.blocks),
                          num_tokens=table.num_tokens)

    def free_table(self, table: BlockTable) -> None:
        for b in table.blocks:
            self.decref(b)
        table.blocks.clear()
        # a table freed while swapped out (finished-while-swapped, or
        # preempted-dropped) must return its host pages too, or the host
        # tier leaks a snapshot nobody can ever reach again
        for h in table.host_blocks:
            self.free_host_block(h)
        table.host_blocks.clear()
        table.num_tokens = 0

    # -- stats -----------------------------------------------------------------
    def utilization(self, tables: List[BlockTable]) -> float:
        """Fraction of *allocated* KV slots holding real tokens (the paper's
        internal-fragmentation metric)."""
        alloc = sum(t.capacity(self.block_size) for t in tables)
        used = sum(t.num_tokens for t in tables)
        return used / alloc if alloc else 1.0


class ContiguousPreallocAllocator:
    """The paper's baseline (ORCA-style): reserve a contiguous max-length
    region per request up front. ``reserve_policy``:

    * "max"    — always ``max_len`` (Orca (Max))
    * "pow2"   — round the true total length up to a power of two (Orca (Pow2))
    * "oracle" — exactly the true total length (Orca (Oracle))
    """

    def __init__(self, total_slots: int, max_len: int, policy: str = "max"):
        self.total_slots = total_slots
        self.max_len = max_len
        self.policy = policy
        self.used_slots = 0
        self.live: Dict[int, int] = {}  # request id -> reserved slots
        self.stored: Dict[int, int] = {}  # request id -> actual tokens

    def reservation(self, true_total_len: int) -> int:
        if self.policy == "max":
            return self.max_len
        if self.policy == "pow2":
            r = 1
            while r < true_total_len:
                r *= 2
            return min(r, self.max_len)
        if self.policy == "oracle":
            return true_total_len
        raise ValueError(self.policy)

    def can_admit(self, true_total_len: int) -> bool:
        return self.used_slots + self.reservation(true_total_len) \
            <= self.total_slots

    def admit(self, rid: int, true_total_len: int) -> None:
        r = self.reservation(true_total_len)
        if self.used_slots + r > self.total_slots:
            raise OutOfBlocks
        self.used_slots += r
        self.live[rid] = r
        self.stored[rid] = 0

    def store(self, rid: int, tokens: int) -> None:
        self.stored[rid] = self.stored.get(rid, 0) + tokens

    def release(self, rid: int) -> None:
        self.used_slots -= self.live.pop(rid)
        self.stored.pop(rid, None)

    def utilization(self) -> float:
        reserved = sum(self.live.values())
        return sum(self.stored.values()) / reserved if reserved else 1.0
