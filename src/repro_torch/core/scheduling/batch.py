"""Batch-level scheduling baseline (the pre-ORCA status quo, §III.B C1).

The serving layer hands the engine a whole batch; the engine runs it to
completion (every request decodes until the *longest* one finishes — padding
waste) before results return and the next batch starts. This is the system
ORCA's iteration-level scheduling replaces; the benchmark quantifies the
gap (queueing delay + early-finish waste).

A copy of ``repro.core.scheduling.batch`` with its imports changed.
"""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.scheduling.request import Phase, Request


@dataclasses.dataclass
class BatchPlan:
    batch: List[Request]

    @property
    def empty(self) -> bool:
        return not self.batch


class BatchScheduler:
    def __init__(self, *, max_batch: int = 8):
        self.max_batch = max_batch
        self.waiting: List[Request] = []
        self.current: List[Request] = []

    def add_request(self, req: Request) -> None:
        req.phase = Phase.WAITING
        self.waiting.append(req)

    def schedule(self) -> BatchPlan:
        """Next whole batch (only when the previous one fully completed)."""
        if self.current:
            return BatchPlan(self.current)
        self.current = self.waiting[:self.max_batch]
        del self.waiting[:len(self.current)]
        for r in self.current:
            r.phase = Phase.INITIATION
        return BatchPlan(self.current)

    def complete_batch(self, now: float) -> List[Request]:
        done = self.current
        for r in done:
            r.phase = Phase.FINISHED
            r.finish_time = now
        self.current = []
        return done
