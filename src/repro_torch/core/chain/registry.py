"""PETALS-style server fleet model (paper §II).

A swarm hosts an L-block model. Each server announces a contiguous span of
blocks, its measured compute throughput ("GPU speed", blocks/s) and the
client-measured network latency (s per hop). Clients build chains of servers
covering blocks [0, L).

A copy of ``repro.core.chain.registry`` with its imports changed.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class ServerInfo:
    server_id: int
    start_block: int  # inclusive
    end_block: int  # exclusive
    throughput: float  # blocks per second ("GPU speed")
    latency: float  # client<->server network latency, seconds

    @property
    def n_blocks(self) -> int:
        return self.end_block - self.start_block

    def hosts(self, block: int) -> bool:
        return self.start_block <= block < self.end_block

    def compute_time(self, n_blocks: int) -> float:
        return n_blocks / self.throughput


@dataclasses.dataclass
class Fleet:
    num_blocks: int
    servers: List[ServerInfo]

    def covering(self, block: int) -> List[ServerInfo]:
        return [s for s in self.servers if s.hosts(block)]

    def is_coverable(self) -> bool:
        return all(self.covering(b) for b in range(self.num_blocks))


def make_fleet(num_blocks: int, num_servers: int, *, seed: int = 0,
               min_span: int = 2, heterogeneity: float = 4.0) -> Fleet:
    """Random geo-distributed swarm: spans, speeds and latencies are drawn
    log-uniformly (heterogeneous consumer hardware, as in the PETALS paper).
    Guarantees full block coverage by seeding a few spanning servers."""
    rng = random.Random(seed)
    servers: List[ServerInfo] = []
    sid = 0

    def add(start, end):
        nonlocal sid
        thr = 10.0 * heterogeneity ** rng.uniform(-1, 1)  # blocks/s
        lat = 0.05 * heterogeneity ** rng.uniform(-1, 1)  # s
        servers.append(ServerInfo(sid, start, end, thr, lat))
        sid += 1

    # coverage backbone: consecutive spans tiling [0, num_blocks)
    b = 0
    while b < num_blocks:
        span = min(rng.randint(min_span, max(min_span, num_blocks // 3)),
                   num_blocks - b)
        add(b, b + span)
        b += span
    # the rest are random spans
    while sid < num_servers:
        start = rng.randrange(0, num_blocks - min_span + 1)
        span = rng.randint(min_span, num_blocks - start)
        add(start, start + span)
    fleet = Fleet(num_blocks, servers)
    assert fleet.is_coverable()
    return fleet
