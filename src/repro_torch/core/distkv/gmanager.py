"""InfiniteLLM gManager: global coordinator + debt ledger (paper §III.D.3).

Maintains per-instance memory availability from periodic heartbeats, builds
the **global debt ledger** (who lent how many rBlocks to whom) and answers
creditor recommendations for a debtor instance. Selection follows the paper:
locality (ring distance between instances, a stand-in for datacenter
topology), availability, and communication cost — the top-3 candidates are
proposed and the debtor tries them in order.

The gManager also hosts the cluster's **prefix publication board**
(``prefixshare.PrefixShareBoard``): instances publish hot radix paths (token
keys + page payloads) through it, and peers adopt them into their own radix
trees — the cross-instance half of prefix caching.

A copy of ``repro.core.distkv.gmanager`` with its imports changed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.distkv.prefixshare import PrefixShareBoard


@dataclasses.dataclass
class Heartbeat:
    instance_id: int
    free_blocks: int
    total_blocks: int


@dataclasses.dataclass
class DebtEntry:
    creditor: int
    debtor: int
    blocks: int


class GManager:
    def __init__(self, num_instances: int, *, safety_free: int = 2,
                 prefix_board_pages: Optional[int] = None):
        self.num_instances = num_instances
        self.free: Dict[int, int] = {i: 0 for i in range(num_instances)}
        self.total: Dict[int, int] = {i: 0 for i in range(num_instances)}
        self.ledger: List[DebtEntry] = []
        self.safety_free = safety_free  # blocks a creditor must keep local
        # cross-instance prefix sharing: published hot radix paths,
        # size-capped (LRU) — publications past the cap evict cold pages
        self.prefix_board = PrefixShareBoard(max_pages=prefix_board_pages)

    # -- heartbeats -----------------------------------------------------------
    def heartbeat(self, hb: Heartbeat) -> None:
        self.free[hb.instance_id] = hb.free_blocks
        self.total[hb.instance_id] = hb.total_blocks

    # -- debt ledger ------------------------------------------------------------
    def lent_by(self, inst: int) -> int:
        return sum(e.blocks for e in self.ledger if e.creditor == inst)

    def borrowed_by(self, inst: int) -> int:
        return sum(e.blocks for e in self.ledger if e.debtor == inst)

    def record_loan(self, creditor: int, debtor: int, blocks: int) -> None:
        for e in self.ledger:
            if e.creditor == creditor and e.debtor == debtor:
                e.blocks += blocks
                return
        self.ledger.append(DebtEntry(creditor, debtor, blocks))

    def record_repayment(self, creditor: int, debtor: int, blocks: int) -> None:
        for e in list(self.ledger):
            if e.creditor == creditor and e.debtor == debtor:
                e.blocks -= blocks
                if e.blocks <= 0:
                    self.ledger.remove(e)
                return
        raise KeyError((creditor, debtor))

    # -- creditor recommendation ---------------------------------------------
    def _distance(self, a: int, b: int) -> int:
        d = abs(a - b)
        return min(d, self.num_instances - d)  # ring topology

    def recommend_creditors(self, debtor: int, blocks: int,
                            k: int = 3) -> List[int]:
        """Top-k candidate creditors: must have spare capacity beyond the
        safety margin; ranked by (locality, then most-available)."""
        cands: List[Tuple[int, int, int]] = []
        for inst in range(self.num_instances):
            if inst == debtor:
                continue
            spare = self.free.get(inst, 0) - self.safety_free
            if spare <= 0:
                continue
            cands.append((self._distance(debtor, inst), -spare, inst))
        cands.sort()
        return [inst for _, _, inst in cands[:k]]

    def snapshot(self) -> Dict[int, Dict]:
        """The paper's Fig. 8 table: per-instance unused/total + debtors."""
        table = {}
        for inst in range(self.num_instances):
            debts = [(e.debtor, e.blocks) for e in self.ledger
                     if e.creditor == inst]
            table[inst] = {"free": self.free.get(inst, 0),
                           "total": self.total.get(inst, 0),
                           "debtors": debts}
        return table
