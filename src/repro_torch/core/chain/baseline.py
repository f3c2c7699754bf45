"""PETALS' original ``find_best_chain`` (paper §II.A.3).

Shortest path from block 0 to block L over a DAG whose nodes are block
boundaries; an edge (i -> j, server s) exists when s hosts blocks [i, j) and
costs network latency + compute time — exactly the paper's description of
the client routing in [Borzunov et al., 2023, Alg. 1].

Two single-objective modes (as in PETALS):
* ``min_latency``  — edge weight = s.latency + (j - i) / s.throughput
* ``max_throughput`` — pick, per block, the fastest server (bottleneck
  throughput maximization for batched fine-tuning workloads).

A copy of ``repro.core.chain.baseline`` with its imports changed.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

from repro_torch.core.chain.registry import Fleet, ServerInfo


class Chain(List[Tuple[ServerInfo, int, int]]):
    """[(server, start_block, end_block), ...] consecutive spans."""

    @property
    def total_latency(self) -> float:
        return sum(s.latency for s, _, _ in self)

    @property
    def total_compute(self) -> float:
        return sum(s.compute_time(e - b) for s, b, e in self)

    @property
    def total_time(self) -> float:
        return self.total_latency + self.total_compute

    @property
    def bottleneck_throughput(self) -> float:
        return min((s.throughput for s, _, _ in self), default=0.0)


def find_best_chain(fleet: Fleet, *, mode: str = "min_latency") -> Optional[Chain]:
    """Dijkstra over block boundaries 0..L. Edge relaxation considers every
    server s and every usable sub-span of s starting at the current boundary."""
    L = fleet.num_blocks
    if mode == "max_throughput":
        return _greedy_throughput_chain(fleet)

    dist = [float("inf")] * (L + 1)
    prev: List[Optional[Tuple[int, ServerInfo]]] = [None] * (L + 1)
    dist[0] = 0.0
    pq = [(0.0, 0)]
    while pq:
        d, i = heapq.heappop(pq)
        if d > dist[i] or i == L:
            continue
        for s in fleet.servers:
            if not s.hosts(i):
                continue
            # use server s for blocks [i, j), any j up to its end
            for j in range(i + 1, min(s.end_block, L) + 1):
                w = s.latency + s.compute_time(j - i)
                if d + w < dist[j]:
                    dist[j] = d + w
                    prev[j] = (i, s)
                    heapq.heappush(pq, (dist[j], j))
    if dist[L] == float("inf"):
        return None
    chain = Chain()
    j = L
    while j > 0:
        i, s = prev[j]
        chain.insert(0, (s, i, j))
        j = i
    return chain


def _greedy_throughput_chain(fleet: Fleet) -> Optional[Chain]:
    """Maximize bottleneck throughput: binary-search the throughput floor,
    keep only servers above it, and check reachability."""
    thrs = sorted({s.throughput for s in fleet.servers}, reverse=True)
    best = None
    for floor in thrs:
        sub = Fleet(fleet.num_blocks,
                    [s for s in fleet.servers if s.throughput >= floor])
        chain = find_best_chain(sub, mode="min_latency") if sub.servers else None
        if chain is not None:
            return chain  # highest floor that still covers -> done
    return best
