"""NSGA-II from scratch (Deb et al. 2002) — pymoo is unavailable offline.

Implements exactly what the paper's §II.B needs: fast non-dominated sorting,
crowding distance, binary tournament selection, single-point crossover,
bit-flip mutation, and Deb's feasibility-first constraint domination (the
paper's "each block must be assigned to at least one server" constraint).

Generic over any problem exposing::

    n_var: int                      # binary genome length
    evaluate(x: np.ndarray) -> (objs: np.ndarray[n_obj], cv: float)

Objectives are minimized; cv <= 0 means feasible.

A copy of ``repro.core.chain.nsga2`` with its imports changed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Individual:
    x: np.ndarray
    f: np.ndarray  # objectives (minimize)
    cv: float  # constraint violation, <=0 feasible
    rank: int = 0
    crowding: float = 0.0


def _dominates(a: Individual, b: Individual) -> bool:
    """Deb's constrained domination."""
    a_feas, b_feas = a.cv <= 0, b.cv <= 0
    if a_feas and not b_feas:
        return True
    if b_feas and not a_feas:
        return False
    if not a_feas and not b_feas:
        return a.cv < b.cv
    return bool(np.all(a.f <= b.f) and np.any(a.f < b.f))


def fast_non_dominated_sort(pop: List[Individual]) -> List[List[int]]:
    n = len(pop)
    S = [[] for _ in range(n)]
    nd = [0] * n
    fronts: List[List[int]] = [[]]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if _dominates(pop[i], pop[j]):
                S[i].append(j)
            elif _dominates(pop[j], pop[i]):
                nd[i] += 1
        if nd[i] == 0:
            pop[i].rank = 0
            fronts[0].append(i)
    k = 0
    while fronts[k]:
        nxt = []
        for i in fronts[k]:
            for j in S[i]:
                nd[j] -= 1
                if nd[j] == 0:
                    pop[j].rank = k + 1
                    nxt.append(j)
        k += 1
        fronts.append(nxt)
    return fronts[:-1]


def crowding_distance(pop: List[Individual], front: Sequence[int]) -> None:
    if not front:
        return
    m = len(pop[front[0]].f)
    for i in front:
        pop[i].crowding = 0.0
    for k in range(m):
        vals = sorted(front, key=lambda i: pop[i].f[k])
        fmin, fmax = pop[vals[0]].f[k], pop[vals[-1]].f[k]
        pop[vals[0]].crowding = pop[vals[-1]].crowding = np.inf
        if fmax == fmin:
            continue
        for a, i, b in zip(vals, vals[1:-1], vals[2:]):
            pop[i].crowding += (pop[b].f[k] - pop[a].f[k]) / (fmax - fmin)


def _tournament(pop: List[Individual], rng: np.random.Generator) -> Individual:
    i, j = rng.integers(0, len(pop), 2)
    a, b = pop[i], pop[j]
    if a.rank != b.rank:
        return a if a.rank < b.rank else b
    return a if a.crowding > b.crowding else b


def single_point_crossover(x1, x2, rng) -> Tuple[np.ndarray, np.ndarray]:
    cut = rng.integers(1, len(x1))
    return (np.concatenate([x1[:cut], x2[cut:]]),
            np.concatenate([x2[:cut], x1[cut:]]))


def bitflip_mutation(x, rng, rate: float) -> np.ndarray:
    flip = rng.random(len(x)) < rate
    y = x.copy()
    y[flip] = 1 - y[flip]
    return y


@dataclasses.dataclass
class NSGA2Result:
    pareto: List[Individual]  # feasible first front
    population: List[Individual]
    evaluations: int


def nsga2(
    evaluate: Callable[[np.ndarray], Tuple[np.ndarray, float]],
    n_var: int,
    *,
    pop_size: int = 100,
    generations: int = 60,
    mutation_rate: float | None = None,
    crossover_prob: float = 0.9,
    seed: int = 0,
    init: Callable[[np.random.Generator], np.ndarray] | None = None,
) -> NSGA2Result:
    rng = np.random.default_rng(seed)
    mutation_rate = mutation_rate if mutation_rate is not None else 1.0 / n_var
    evals = 0

    def make(x) -> Individual:
        nonlocal evals
        f, cv = evaluate(x)
        evals += 1
        return Individual(x=x, f=np.asarray(f, float), cv=float(cv))

    if init is None:
        init = lambda r: (r.random(n_var) < 0.3).astype(np.int8)
    pop = [make(init(rng)) for _ in range(pop_size)]
    fronts = fast_non_dominated_sort(pop)
    for fr in fronts:
        crowding_distance(pop, fr)

    for _ in range(generations):
        children = []
        while len(children) < pop_size:
            p1, p2 = _tournament(pop, rng), _tournament(pop, rng)
            if rng.random() < crossover_prob:
                c1, c2 = single_point_crossover(p1.x, p2.x, rng)
            else:
                c1, c2 = p1.x.copy(), p2.x.copy()
            children.append(make(bitflip_mutation(c1, rng, mutation_rate)))
            if len(children) < pop_size:
                children.append(make(bitflip_mutation(c2, rng, mutation_rate)))
        union = pop + children
        fronts = fast_non_dominated_sort(union)
        newpop: List[Individual] = []
        for fr in fronts:
            crowding_distance(union, fr)
            if len(newpop) + len(fr) <= pop_size:
                newpop.extend(union[i] for i in fr)
            else:
                rest = sorted(fr, key=lambda i: -union[i].crowding)
                newpop.extend(union[i]
                              for i in rest[:pop_size - len(newpop)])
                break
        pop = newpop

    fronts = fast_non_dominated_sort(pop)
    pareto = [pop[i] for i in fronts[0] if pop[i].cv <= 0]
    return NSGA2Result(pareto=pareto, population=pop, evaluations=evals)


def hypervolume_2d(points: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-objective hypervolume (minimization, reference point ``ref``)."""
    pts = points[np.all(points <= ref, axis=1)]
    if len(pts) == 0:
        return 0.0
    pts = pts[np.argsort(pts[:, 0])]
    hv = 0.0
    cur_f1 = ref[1]
    for f0, f1 in pts:
        if f1 < cur_f1:
            hv += (ref[0] - f0) * (cur_f1 - f1)
            cur_f1 = f1
    return hv
