"""The port's serving simulator against the JAX package's, on the CPU.

``repro_torch.serving.simulator`` and ``repro_torch.core.scheduling.batch``
are copies of the reference's modules with their imports changed, driving
the port's copies of the scheduler, allocator, radix cache, router, disagg
roles and distkv ledgers. The clock is virtual, so the same seeded inputs
must give equal results, compared with ``==``: every request's times,
outputs and preemptions, the makespan, KV utilisation, swap counts, and the
trace events and metric timelines where a run traces. There is no
tolerance to state.

The last tests put the port's ``PagedEngine`` (smoke danube, float32) and
its ``SimBackend`` behind one ``RouterBackend``, as the reference's
``tests/test_router.py`` does, and hold the engine's tokens to the JAX
engine's; and show that an engine and a simulator with the same scheduler
settings plan the same iterations for the same requests.
"""

import dataclasses
import enum
import types

import jax
import numpy as np
import pytest

import repro.serving.simulator as jax_sim
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.distkv.netmodel import NetworkModel as JaxNetworkModel
from repro.core.paging.layout import KVPageLayout as JaxLayout
from repro.core.scheduling.request import Request as JaxRequest
from repro.models import Model as JaxModel
from repro.serving.api import LLMService as JaxService
from repro.serving.api import SamplingParams as JaxSamplingParams
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.router import RouterBackend as JaxRouter

import repro_torch.serving.simulator as sim
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.distkv.netmodel import NetworkModel
from repro_torch.core.paging.layout import KVPageLayout
from repro_torch.core.scheduling.request import Request
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine
from repro_torch.serving.router import RouterBackend

SIDES = {
    "jax": types.SimpleNamespace(
        sim=jax_sim, net=JaxNetworkModel, layout=JaxLayout,
        get_config=jax_get_config, service=JaxService),
    "port": types.SimpleNamespace(
        sim=sim, net=NetworkModel, layout=KVPageLayout,
        get_config=get_config, service=LLMService),
}


def _plain(x):
    """``x`` as plain data of builtins, so that the two packages' objects
    compare with ``==``: dataclasses and slotted objects as dicts of their
    fields, enums by name, numpy values as Python ones, NaN as a string."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"type": type(x).__name__,
                **{f.name: _plain(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return _plain(x.tolist())
    if isinstance(x, (float, np.floating)):
        return "nan" if x != x else float(x)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    if hasattr(type(x), "__slots__") and not isinstance(x, (str, int)):
        return {"type": type(x).__name__,
                **{s: _plain(getattr(x, s)) for s in type(x).__slots__}}
    assert x is None or isinstance(x, (str, int)), type(x)
    return x


def _both(case):
    """``case(side)`` for both packages, as plain data."""
    return _plain(case(SIDES["jax"])), _plain(case(SIDES["port"]))


# -- workload generators ------------------------------------------------------

WORKLOADS = {
    "sharegpt long": lambda s: s.sim.make_workload(
        120, rate=6.0, seed=3, long_frac=0.1, long_len=6000),
    "alpaca tokens": lambda s: s.sim.make_workload(
        80, rate=20.0, dist="alpaca", seed=4, materialize_tokens=True),
    "shared prefix": lambda s: s.sim.make_shared_prefix_workload(
        60, rate=10.0, n_groups=3, group_draw="random", seed=5),
    "few shot": lambda s: s.sim.make_few_shot_workload(
        40, rate=12.0, template_len=300, seed=6),
    "multi turn": lambda s: s.sim.make_multi_turn_workload(
        8, 4, rate=2.0, seed=7),
}


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_generators_equal(name):
    ref, port = _both(WORKLOADS[name])
    assert ref == port and len(port) > 0


# -- simulate_paged and SimBackend --------------------------------------------

def _sharegpt(s, n=70, rate=18.0, seed=11):
    return s.sim.make_workload(n, rate=rate, seed=seed)


def _multi_turn(s):
    return s.sim.make_multi_turn_workload(10, 4, rate=3.0, system_len=200,
                                          seed=13)


def _backend_run(s, requests, **kw):
    """A SimBackend of ``kw`` behind LLMService.replay: the outputs, the
    stats, the requests and the backend's counters."""
    backend = s.sim.SimBackend(**kw)
    outs, stats = s.service(backend).replay(requests)
    pc = backend.prefix_cache
    return dict(outs=outs, stats=stats, requests=requests,
                clock=backend.clock(), iterations=backend.iterations,
                preemptions=backend.preemptions,
                kv_utilization=backend.kv_utilization,
                swapped=(backend.swapped_out, backend.swapped_in,
                         backend.swap_cancels, backend.swap_time_s),
                cache=None if pc is None else (
                    pc.hit_rate, pc.num_pages, pc.spilled_pages,
                    pc.restored_pages),
                events=backend.trace.events() if backend.trace else None,
                timeline=backend.metrics.rows() if backend.metrics else None)


def _mla_layout(s):
    return s.layout.from_arch(s.get_config("deepseek-v2-236b"))


def _paged(workload=_sharegpt, **kw):
    return lambda s: s.sim.simulate_paged(workload(s), **kw)


PAGED = {
    **{f"chunk {p}": _paged(num_blocks=400, max_tokens_per_iter=512,
                            chunk_policy=p)
       for p in ("decode_first", "prefill_first", "monolithic", "solo")},
    "max preemptions": _paged(num_blocks=300, max_preemptions=2),
    "prefix cache, traced": _paged(
        lambda s: s.sim.make_shared_prefix_workload(
            80, rate=15.0, n_groups=4, seed=12),
        num_blocks=600, prefix_cache=True, trace=True),
    **{f"{m}, {v}": _paged(num_blocks=300, host_blocks=600, swap_mode=m,
                           victim_policy=v, trace=True)
       for m in ("sacrifice", "swap", "auto") for v in ("lifo", "cost")},
    "swap overlap": lambda s: s.sim.simulate_paged(
        _sharegpt(s), num_blocks=300, host_blocks=600, swap_mode="swap",
        swap_overlap=True, net=s.net(pcie_gbps=64.0)),
    "speculative swap, traced": lambda s: s.sim.simulate_paged(
        _sharegpt(s), num_blocks=300, host_blocks=600, swap_mode="swap",
        speculative_swap=True, trace=True),
    "cache spill": lambda s: _backend_run(
        s, _multi_turn(s), num_blocks=160, prefix_cache=True,
        host_blocks=64, cache_spill_pages=32, trace=True),
    "mla layout, auto + cost": lambda s: _backend_run(
        s, _sharegpt(s), num_blocks=300, host_blocks=600, swap_mode="auto",
        victim_policy="cost", layout=_mla_layout(s)),
    "replay": lambda s: _backend_run(
        s, s.sim.make_workload(150, rate=30.0, dist="alpaca", seed=14),
        num_blocks=200, max_running=32),
}


@pytest.mark.parametrize("name", PAGED)
def test_paged_runs_equal(name):
    ref, port = _both(PAGED[name])
    assert ref == port
    finished = [r["finish_time"] is not None for r in port["requests"]]
    if name == "cache spill":
        # the radix cache cannot evict past a spilled page, in both
        # packages (ROADMAP §3): both stall at the same request, and
        # LLMService.drain gives up there
        assert 0 < sum(finished) < len(finished)
    else:
        assert all(finished)


def test_paged_cases_reach_their_paths():
    """The cases above do what their names say: they preempt, swap,
    cancel speculative swap-outs, hit and spill the prefix cache and
    charge the MLA layout's page bytes (so their equality means
    something)."""
    s = SIDES["port"]
    assert PAGED["max preemptions"](s).preemptions > 0
    assert PAGED["chunk decode_first"](s).preemptions > 0
    assert PAGED["swap, lifo"](s).swapped_out > 0
    assert PAGED["swap overlap"](s).swapped_in > 0
    spec = PAGED["speculative swap, traced"](s)
    assert spec.swapped_out > 0 and spec.events
    assert PAGED["prefix cache, traced"](s).prefix_hit_rate > 0.3
    spill = PAGED["cache spill"](s)
    assert spill["cache"][2] > 0 and spill["cache"][3] > 0
    mla = PAGED["mla layout, auto + cost"](s)
    gqa = _backend_run(s, _sharegpt(s), num_blocks=300, host_blocks=600,
                       swap_mode="auto", victim_policy="cost")
    assert mla["swapped"][0] > 0 and mla["swapped"] != gqa["swapped"]


# -- the baselines: prealloc (ORCA), batch level, DistKV ----------------------

def _prealloc(policy):
    return lambda s: s.sim.simulate_prealloc(
        s.sim.make_workload(120, rate=20.0, seed=4), total_slots=20_000,
        policy=policy)


def _distkv(borrow):
    return lambda s: s.sim.simulate_distkv(
        s.sim.make_workload(60, rate=10.0, seed=1, long_frac=0.1,
                            long_len=6000, max_len=512),
        blocks_per_instance=200, borrow=borrow)


BASELINES = {
    **{f"prealloc {p}": _prealloc(p) for p in ("oracle", "pow2", "max")},
    "batch level": lambda s: s.sim.simulate_batch_level(
        s.sim.make_workload(80, rate=4.0, seed=6), max_batch=16),
    **{f"distkv borrow {b}": _distkv(b) for b in (True, False)},
}


@pytest.mark.parametrize("name", BASELINES)
def test_baselines_equal(name):
    ref, port = _both(BASELINES[name])
    assert ref == port and ref["makespan"] > 0


# -- the cluster: router policies, share modes, disaggregation ----------------

def _tenants(s, seed=15):
    return s.sim.make_shared_prefix_workload(
        120, rate=40.0, n_groups=4, prefix_len=256, group_draw="random",
        seed=seed)


def _router(**kw):
    return lambda s: s.sim.simulate_router(
        _tenants(s), blocks_per_instance=300, **kw)


CLUSTER = {
    **{f"router {p}": _router(policy=p)
       for p in ("round_robin", "least_loaded", "prefix_affinity")},
    **{f"share {m}": lambda s, m=m: _router(
        policy="round_robin", prefix_share=True, share_mode=m,
        net=s.net(gbps=100), trace=True)(s)
       for m in ("copy", "zero_copy", "auto")},
    "disagg 2p2d auto": lambda s: s.sim.simulate_disagg(
        _sharegpt(s, n=80), roles="2p2d", handoff_mode="auto",
        blocks_per_instance=400, trace=True),
    "disagg 1p2d1m zero_copy": lambda s: s.sim.simulate_disagg(
        _sharegpt(s, n=80), roles="1p2d1m", handoff_mode="zero_copy",
        blocks_per_instance=400, net=s.net(gbps=100)),
}


@pytest.mark.parametrize("name", CLUSTER)
def test_cluster_runs_equal(name):
    ref, port = _both(CLUSTER[name])
    assert ref == port
    assert port["per_instance"]
    assert all(r["finish_time"] is not None for r in port["requests"])


def test_cluster_cases_reach_their_paths():
    s = SIDES["port"]
    assert CLUSTER["share copy"](s).adopted_pages > 0
    zc = CLUSTER["share zero_copy"](s)
    assert zc.borrowed_pages > 0 and zc.net_time > 0 and zc.events
    d = CLUSTER["disagg 2p2d auto"](s)
    assert d.handoffs_migrated + d.handoffs_leased > 0 and d.role_timelines
    assert CLUSTER["disagg 1p2d1m zero_copy"](s).handoffs_leased > 0


# -- the launcher's simulator backend -----------------------------------------

LAUNCHES = {
    "single": ["--requests", "60", "--rate", "10"],
    "prefix affinity": ["--requests", "120", "--rate", "40",
                        "--instances", "4", "--policy", "prefix_affinity",
                        "--prefix-cache", "--prefix-share"],
    "2p2d": ["--requests", "80", "--rate", "20", "--roles", "2p2d"],
    "swap lane": ["--requests", "60", "--rate", "1000", "--pages", "16",
                  "--host-pages", "64", "--swap-mode", "swap",
                  "--swap-overlap", "--max-new", "64", "--pcie-gbps", "400",
                  "--t-swap-fixed", "1e-5"],
}


@pytest.mark.parametrize("name", LAUNCHES)
def test_launcher_sim_backend_prints_the_reference_numbers(
        name, monkeypatch, capsys):
    """``--backend sim`` runs without a GPU (``torch.cuda.is_available``
    patched to False: the simulator asks for no device) and prints what
    the reference launcher prints for the same flags."""
    import sys

    import torch

    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    argv = ["--backend", "sim", *LAUNCHES[name]]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jax_serve.main()
    ref = capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    serve.main(argv)
    port = capsys.readouterr().out
    assert port == ref and "served" in port
    if name == "swap lane":
        assert "host swap" in port


def test_launcher_calibration_reaches_the_swap_lane():
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        ["--backend", "sim", "--pcie-gbps", "400", "--t-swap-fixed", "1e-5"])
    backend = serve.build_backend(args)
    assert backend.swap_net.pcie_gbps == 400.0
    assert backend.swap_net.t_swap_fixed == 1e-5
    args = serve.build_parser().parse_args(["--backend", "sim"])
    assert serve.build_netmodel(args) is None


# -- engine and simulator children behind one router --------------------------

PS = 8


@pytest.fixture(scope="module")
def danube():
    jcfg = dataclasses.replace(jax_smoke_config("h2o-danube-1.8b"),
                               dtype="float32", logits_fp32=True)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    return dict(jcfg=jcfg, jparams=jparams,
                tcfg=ArchConfig(**dataclasses.asdict(jcfg)), tparams=tparams)


def _engine(setup, side, **kw):
    ekw = dict(dict(num_pages=64, page_size=PS, max_slots=4), **kw)
    if side == "jax":
        return JaxEngine(setup["jcfg"], setup["jparams"],
                         JaxEngineConfig(**ekw))
    return PagedEngine(setup["tcfg"], setup["tparams"], EngineConfig(**ekw),
                       device="cpu")


def _mixed_router(setup, side):
    """The reference's ``test_router_mixed_engine_and_sim_children``:
    an engine and a simulator, round robin, four prompts of 6 tokens."""
    s = SIDES[side]
    router = (JaxRouter if side == "jax" else RouterBackend)(
        [_engine(setup, side), s.sim.SimBackend(num_blocks=64, block_size=8)],
        policy="round_robin")
    clock = router.clock()
    rng = np.random.default_rng(9)
    sp = (JaxSamplingParams if side == "jax" else SamplingParams)(
        max_new_tokens=3)
    outs = s.service(router).generate(
        [rng.integers(0, setup["tcfg"].vocab_size, 6).tolist()
         for _ in range(4)], sp)
    return clock, outs


def test_router_mixed_engine_and_sim_children(danube):
    (jclock, jouts), (clock, outs) = (_mixed_router(danube, side)
                                      for side in ("jax", "port"))
    assert clock is None and jclock is None
    assert [o.metrics.instance_id for o in outs] == [0, 1, 0, 1]
    assert all(o.finish_reason == "length" for o in outs)
    for i, (a, b) in enumerate(zip(jouts, outs)):
        assert len(b.token_ids) == 3
        if i % 2 == 0:  # the engine child: tokens equal the JAX engine's
            assert b.token_ids == a.token_ids
            assert all(np.isfinite(b.samples[0].token_logprobs))
        else:  # the simulator child: placeholder tokens, no logprobs
            assert b.token_ids == a.token_ids == [0, 0, 0]
            assert b.samples[0].token_logprobs is None


class Scripted:
    def __init__(self, script):
        self.script = list(script)

    def choose(self, req, children):
        return self.script.pop(0)


def _payloadless_share(setup, side):
    """The reference's ``test_mixed_cluster_share_engine_skips_payloadless
    _pages``: a simulator child publishes pages without payloads; the
    engine peer must neither crash on them nor adopt them."""
    s = SIDES[side]
    R = JaxRequest if side == "jax" else Request
    eng = _engine(setup, side, enable_prefix_cache=True)
    router = (JaxRouter if side == "jax" else RouterBackend)(
        [s.sim.SimBackend(num_blocks=64, block_size=PS, prefix_cache=True),
         eng], policy=Scripted([0, 0, 1]), prefix_share=True,
        hot_threshold=1)
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, setup["tcfg"].vocab_size, 2 * PS).tolist()
    reqs = [R(i, 0.0, prefix + rng.integers(
        0, setup["tcfg"].vocab_size, 3).tolist(), max_new_tokens=2)
        for i in range(3)]
    for i in (0, 1, 2):
        if i == 2:
            published = router.g.prefix_board.published_pages
        router.add_request(reqs[i])
        while router.has_work:
            router.step()
    return published, eng.prefix_cache.adopted_pages, reqs[2]


def test_payloadless_sim_pages_are_not_adopted(danube):
    (jpub, jadopted, jreq), (pub, adopted, req) = (
        _payloadless_share(danube, side) for side in ("jax", "port"))
    assert pub == jpub and pub >= 2
    assert adopted == jadopted == 0
    assert req.instance_id == 1 and req.num_cached_tokens == 0
    assert req.full_output == jreq.full_output and len(req.full_output) == 2


# -- the same plans on an engine and a simulator ------------------------------

def _plan_log(backend):
    """Wrap ``backend``'s scheduler so that each plan's shape is recorded:
    (tokens, decode ids, chunks as (id, start, length), preempted ids)."""
    log = []
    schedule = backend.scheduler.schedule

    def spied():
        plan = schedule()
        log.append((plan.token_count(),
                    tuple(r.request_id for r in plan.decode),
                    tuple((c.req.request_id, c.start, c.length)
                          for c in plan.chunks),
                    tuple(r.request_id for r in plan.preempted)))
        return plan

    backend.scheduler.schedule = spied
    return log


@pytest.mark.parametrize("pages,new", [(64, 6), (10, 20)])
def test_engine_and_simulator_plan_the_same_iterations(danube, pages, new):
    """The port's CPU engine and the port's SimBackend with the engine's
    scheduler settings, on the same requests (all at t = 0, prompts longer
    than the token budget, so they chunk): equal plans, iteration by
    iteration. On 10 pages of 8 they also preempt and recompute alike."""
    ekw = dict(num_pages=pages, page_size=PS, max_slots=4,
               max_tokens_per_iter=32)
    engine = _engine(danube, "port", **ekw)
    backend = sim.SimBackend(num_blocks=pages, block_size=PS, max_running=4,
                             max_tokens_per_iter=32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, danube["tcfg"].vocab_size, n).tolist()
               for n in (40, 9, 23, 17, 50)]
    logs = []
    for b in (engine, backend):
        log = _plan_log(b)
        for i, p in enumerate(prompts):
            b.add_request(Request(i, 0.0, list(p), max_new_tokens=new))
        while b.has_work:
            b.step()
        logs.append(log)
    assert logs[0] == logs[1]
    assert any(len(p[2]) and p[1] for p in logs[0])  # chunks beside decodes
    if pages == 10:
        assert engine.preemptions == backend.preemptions > 0
