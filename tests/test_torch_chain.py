"""The port's chain selection and the paper's two studies against the JAX
package's, on the CPU.

``repro_torch.core.chain`` is a copy of ``repro.core.chain`` (numpy and the
standard library's ``random``) with its imports changed, so the same seeds
must give equal fleets, Dijkstra and max-throughput chains, NSGA-II fronts
and populations, hypervolumes, tradeoff chains and knees, compared with
``==``. The port's study benchmarks (``benchmarks/torch_serving_fig9.py``,
``torch_serving_fig10.py``, ``torch_chain_compare.py``) must return the
reference benchmarks' rows at a small size; only the chain study's
optimizer wall times, which are host time, are left out of the comparison.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import repro.core.chain as jax_chain
from repro.core.chain.nsga2 import nsga2 as jax_nsga2

import repro_torch.core.chain as chain
from repro_torch.core.chain.nsga2 import nsga2

from test_torch_sim import _plain

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jax_chain, "port": chain}


def _both(case):
    return _plain(case(jax_chain)), _plain(case(chain))


FLEETS = [(10, 12, 0), (12, 16, 9), (24, 24, 3), (16, 8, 41)]


@pytest.mark.parametrize("blocks,servers,seed", FLEETS)
def test_fleets_and_baseline_chains_equal(blocks, servers, seed):
    def case(c):
        fleet = c.make_fleet(blocks, servers, seed=seed)
        return dict(fleet=fleet, coverable=fleet.is_coverable(),
                    **{mode: c.find_best_chain(fleet, mode=mode)
                       for mode in ("min_latency", "max_throughput")})

    ref, port = _both(case)
    assert ref == port and port["coverable"] and port["min_latency"]


def _toy(x):
    """Two competing objectives over bits (tests/test_chain.py)."""
    f0 = float(x.sum())
    return np.array([f0, float(len(x) - f0 + x[0] * 3)]), 0.0


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_nsga2_equal(seed):
    ref, port = (_plain(fn(_toy, n_var=12, pop_size=20, generations=10,
                           seed=seed)) for fn in (jax_nsga2, nsga2))
    assert ref == port and port["pareto"]


def test_hypervolume_equal():
    rng = np.random.default_rng(5)
    for _ in range(20):
        pts = rng.random((int(rng.integers(1, 9)), 2))
        ref = np.array([1.0, rng.uniform(0.5, 1.5)])
        assert jax_chain.hypervolume_2d(pts, ref) == \
            chain.hypervolume_2d(pts, ref)


TRADEOFFS = {
    "paper": dict(objectives="paper"),
    "realized": dict(objectives="realized"),
    "realized, memetic": dict(objectives="realized", memetic_seed=True),
}


@pytest.mark.parametrize("name", TRADEOFFS)
def test_tradeoff_fronts_chains_and_knee_equal(name):
    def case(c):
        fleet = c.make_fleet(10, 12, seed=4)
        res = c.latency_throughput_tradeoff(
            fleet, pop_size=30, generations=15, seed=11, **TRADEOFFS[name])
        return dict(result=res, knee=c.knee_chain(res))

    ref, port = _both(case)
    assert ref == port and port["knee"]
    covered = sorted(b for _, a, e in port["knee"] for b in range(a, e))
    assert covered == list(range(10))


def test_decode_chain_equal():
    def case(c):
        fleet = c.make_fleet(12, 16, seed=9)
        prob = c.ChainSequenceProblem(fleet, objectives="realized")
        rng = np.random.default_rng(2)
        xs = [prob.seeded_init(rng) for _ in range(8)]
        return [(c.decode_chain(prob, x), prob.evaluate(x)) for x in xs]

    ref, port = _both(case)
    assert ref == port


# -- the study benchmarks ------------------------------------------------------

def _bench(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _untimed(rows_agg):
    """chain_compare's rows and means without the optimizer's wall times."""
    rows, agg = rows_agg
    drop = ("t_dij_ms", "t_ga_ms")
    return ([{k: v for k, v in r.items() if k not in drop} for r in rows],
            {k: v for k, v in agg.items() if k not in drop})


BENCHMARKS = {
    "serving_fig9": (dict(n_requests=40), lambda out: out),
    "serving_fig10": (dict(n_requests=40), lambda out: out),
    "chain_compare": (dict(n_fleets=2, blocks=12, servers=12,
                           generations=10), _untimed),
}


@pytest.mark.parametrize("name", BENCHMARKS)
def test_study_benchmarks_give_the_reference_rows(name, capsys):
    kw, keep = BENCHMARKS[name]
    ref = keep(_bench(name).run(**kw))
    ref_out = capsys.readouterr().out
    port = keep(_bench(f"torch_{name}").run(**kw))
    port_out = capsys.readouterr().out
    assert _plain(port) == _plain(ref) and port
    if name != "chain_compare":  # its printed lines carry wall times
        assert port_out == ref_out
