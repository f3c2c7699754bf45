"""The paper's novel contribution (§II.B): "Latency-Throughput-Tradeoff"
chain selection via NSGA-II.

Chromosome (exactly as §II.B.2): a binary matrix, rows = servers, columns =
model blocks; entry (s, b) = 1 means server s is used for block b. Objectives
(§II.B.4): minimize the sum of latencies and maximize the sum of throughputs
across all blocks; constraint: every block assigned to >=1 hosting server.

``decode_chain`` turns a feasible matrix into an executable chain (per block,
the assigned hosting server with the highest throughput; consecutive equal
servers merge into spans), which gives the *realized* latency/throughput used
by the comparison benchmark — the experiment the paper itself could not run
(§II.B.5) for lack of a private swarm.

A copy of ``repro.core.chain.tradeoff`` with its imports changed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.chain.nsga2 import nsga2 as _run_nsga2
from repro_torch.core.chain.baseline import Chain
from repro_torch.core.chain.registry import Fleet, ServerInfo


@dataclasses.dataclass
class ChainSequenceProblem:
    """pymoo-style Problem (the paper used pymoo's ``Problem``; we implement
    the same interface against our own NSGA-II).

    ``objectives``:

    * ``"paper"``    — exactly §II.B.4: minimize the *sum of latencies* and
      maximize the *sum of throughputs* over all engaged (server, block)
      assignments. Our benchmark shows these reward engaging many servers
      and produce chains dominated by the Dijkstra baseline on realized
      metrics — a finding about the paper's objective design.
    * ``"realized"`` — beyond-paper fix: minimize the *decoded chain's*
      end-to-end time and maximize its *bottleneck throughput* (what a
      client actually experiences). Same chromosome, same operators.
    """

    fleet: Fleet
    objectives: str = "paper"

    def __post_init__(self):
        self.n_servers = len(self.fleet.servers)
        self.n_blocks = self.fleet.num_blocks
        self.n_var = self.n_servers * self.n_blocks
        # hosting mask: H[s, b] = server s hosts block b
        self.hosts = np.zeros((self.n_servers, self.n_blocks), bool)
        for i, s in enumerate(self.fleet.servers):
            self.hosts[i, s.start_block:s.end_block] = True
        self.lat = np.array([s.latency for s in self.fleet.servers])
        self.thr = np.array([s.throughput for s in self.fleet.servers])

    def evaluate(self, x: np.ndarray) -> Tuple[np.ndarray, float]:
        m = x.reshape(self.n_servers, self.n_blocks) & self.hosts
        # constraint: every block covered by at least one valid server
        uncovered = int(self.n_blocks - m.any(axis=0).sum())
        # discourage dead bits (assignments to non-hosted blocks)
        dead = int((x.reshape(self.n_servers, self.n_blocks) & ~self.hosts).sum())
        cv = float(uncovered) + 0.001 * dead
        if self.objectives == "realized":
            chain = decode_chain(self, x) if uncovered == 0 else None
            if chain is None:
                return np.array([1e9, 1e9]), max(cv, 1.0)
            return np.array([chain.total_time,
                             -chain.bottleneck_throughput]), cv
        # paper objectives (§II.B.4)
        f0 = float((m * self.lat[:, None]).sum())
        f1 = -float((m * self.thr[:, None]).sum())
        return np.array([f0, f1]), cv

    def chain_to_x(self, chain: Chain) -> np.ndarray:
        """Encode an executable chain as a chromosome (for memetic seeding)."""
        m = np.zeros((self.n_servers, self.n_blocks), np.int8)
        for s, a, b in chain:
            m[s.server_id, a:b] = 1
        return m.reshape(-1)

    def seeded_init(self, rng: np.random.Generator) -> np.ndarray:
        """Random column-wise covering assignment (keeps the initial
        population feasible, as pymoo users typically seed)."""
        m = np.zeros((self.n_servers, self.n_blocks), np.int8)
        for b in range(self.n_blocks):
            cands = np.flatnonzero(self.hosts[:, b])
            m[rng.choice(cands), b] = 1
        # sprinkle extra redundancy
        extra = (rng.random(m.shape) < 0.05) & self.hosts
        return (m | extra).reshape(-1).astype(np.int8)


def decode_chain(problem: ChainSequenceProblem, x: np.ndarray) -> Optional[Chain]:
    """Feasible matrix -> executable chain (per-block fastest assigned server,
    merged into consecutive spans)."""
    m = x.reshape(problem.n_servers, problem.n_blocks) & problem.hosts
    if not m.any(axis=0).all():
        return None
    servers = problem.fleet.servers
    pick: List[ServerInfo] = []
    for b in range(problem.n_blocks):
        cands = np.flatnonzero(m[:, b])
        pick.append(servers[cands[np.argmax(problem.thr[cands])]])
    chain = Chain()
    start = 0
    for b in range(1, problem.n_blocks + 1):
        if b == problem.n_blocks or pick[b].server_id != pick[start].server_id:
            chain.append((pick[start], start, b))
            start = b
    return chain


@dataclasses.dataclass
class TradeoffResult:
    pareto_front: np.ndarray  # (n, 2) [latency, -throughput]
    chains: List[Chain]
    evaluations: int


def latency_throughput_tradeoff(
    fleet: Fleet, *, pop_size: int = 100, generations: int = 60,
    seed: int = 0, objectives: str = "paper",
    memetic_seed: bool = False) -> TradeoffResult:
    """The paper's new PETALS mode. Returns the Pareto set of chains.

    ``memetic_seed`` (beyond-paper): inject the Dijkstra min-latency and
    max-throughput chains into the initial population — NSGA-II elitism then
    guarantees the final front dominates both single-objective baselines and
    the GA explores the middle of the tradeoff curve."""
    from repro_torch.core.chain.baseline import find_best_chain
    prob = ChainSequenceProblem(fleet, objectives=objectives)
    seeds_x = []
    if memetic_seed:
        for mode in ("min_latency", "max_throughput"):
            c = find_best_chain(fleet, mode=mode)
            if c is not None:
                seeds_x.append(prob.chain_to_x(c))
    counter = {"i": 0}

    def init(rng):
        i = counter["i"]
        counter["i"] += 1
        if i < len(seeds_x):
            return seeds_x[i].copy()
        return prob.seeded_init(rng)

    res = _run_nsga2(prob.evaluate, prob.n_var, pop_size=pop_size,
                     generations=generations, seed=seed, init=init)
    chains, front = [], []
    for ind in res.pareto:
        c = decode_chain(prob, ind.x)
        if c is not None:
            chains.append(c)
            front.append(ind.f)
    return TradeoffResult(
        pareto_front=np.array(front).reshape(-1, 2),
        chains=chains, evaluations=res.evaluations)


def knee_chain(result: TradeoffResult) -> Optional[Chain]:
    """Pick the knee of the Pareto front (max distance to the extremes'
    chord) — a sensible single default for clients."""
    if not result.chains:
        return None
    f = result.pareto_front.astype(float)
    f = (f - f.min(0)) / np.maximum(f.max(0) - f.min(0), 1e-12)
    a, b = f[np.argmin(f[:, 0])], f[np.argmin(f[:, 1])]
    ab = b - a
    denom = np.linalg.norm(ab) + 1e-12
    fa = f - a
    d = np.abs(ab[0] * fa[:, 1] - ab[1] * fa[:, 0]) / denom  # 2-D cross
    return result.chains[int(np.argmax(d))]
