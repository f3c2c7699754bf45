"""The tiered KV memory on the port against the JAX package, on the CPU, in
float32 (``dtype="float32", logits_fp32=True``): swap-to-host preemption,
speculative (issue / complete / cancel) swap-outs, ``auto`` swaps with
cost-ranked victims, a leased borrower under pressure, the preemption
budget, prefix-cache spill to host pages and the router's peer spill tier.

Each engine run goes in lock step with the JAX engine of the same
configuration on the same weights (carried over by the bridge): after
every iteration both plans must move the same requests' pages between the
same device and host pages, every host page that holds a payload must
equal the JAX engine's at the KV tolerance of the engine tests (1e-2
worst, 1e-5 median: a one-ulp float32 difference can flip a bf16 rounding
in a deeper layer), and the greedy tokens must be identical. The port's
exported trace must pass ``validate_trace_events`` and
``validate_swap_balance``, and a request swapped in while decoding must
run no prefill chunk afterwards (it resumes, it does not re-prefill). In
bfloat16 the port's swap round trip is checked bit for bit against its own
pages as they were before the swap-out.

The crunch is ``tests/test_swap.py``'s: pages of 8 tokens, 2 decode
slots, 16 host pages, smoke h2o-danube-1.8b without its window (GQA) and
smoke deepseek-v2-236b (MLA).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.scheduling.request import Request as JaxRequest
from repro.models import Model as JaxModel
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.router import RouterBackend as JaxRouter

from repro_torch.bridge import from_numpy_tree, init_params
from repro_torch.configs import ArchConfig, smoke_config
from repro_torch.core.scheduling.request import Request
from repro_torch.core.telemetry import (to_chrome_trace, validate_swap_balance,
                                        validate_trace_events)
from repro_torch.launch import serve
from repro_torch.serving.engine import EngineConfig, PagedEngine
from repro_torch.serving.router import RouterBackend

PS = 8
CRUNCH = dict(num_pages=8, page_size=PS, max_slots=2, host_pages=16)
MOVES = ("swap_out", "swap_in", "swap_issue", "swap_complete", "swap_cancel")


def _setup(arch, **kw):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               logits_fp32=True, **kw)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    return dict(jcfg=jcfg, jparams=jparams,
                tcfg=ArchConfig(**dataclasses.asdict(jcfg)), tparams=tparams)


@pytest.fixture(scope="module")
def gqa():
    return _setup("h2o-danube-1.8b", sliding_window=None)


@pytest.fixture(scope="module")
def mla():
    return _setup("deepseek-v2-236b")


@pytest.fixture
def setup(request):
    return request.getfixturevalue(request.param)


def _engine(setup, side, **kw):
    if side == "jax":
        return JaxEngine(setup["jcfg"], setup["jparams"], JaxEngineConfig(
            use_kernel=False, enable_telemetry=True, **kw))
    return PagedEngine(setup["tcfg"], setup["tparams"],
                       EngineConfig(enable_telemetry=True, **kw),
                       device="cpu")


def _engines(setup, **kw):
    return _engine(setup, "jax", **kw), _engine(setup, "port", **kw)


def _spy(engine):
    """Record every plan ``engine``'s scheduler makes."""
    plans = []
    schedule = engine.scheduler.schedule

    def recording():
        plans.append(schedule())
        return plans[-1]

    engine.scheduler.schedule = recording
    return plans


def _moves(plan):
    out = {k: [(r.request_id, [(int(d), int(h)) for d, h in pairs])
               for r, pairs in getattr(plan, k)] for k in MOVES}
    out["preempted"] = [r.request_id for r in plan.preempted]
    out["chunks"] = [(c.req.request_id, c.start, c.length)
                     for c in plan.chunks]
    return out


def _live_host_pages(engine):
    """Host pages holding a payload: those of swapped-out tables whose
    swap is not in flight, and those of spilled prefix-cache pages."""
    a = engine.allocator
    pending = {h for pairs in a._pending_out.values() for _, h in pairs}
    pages = {h for t in engine.scheduler.tables.values()
             for h in t.host_blocks if h not in pending}
    pc = engine.prefix_cache
    if pc is not None:
        pages |= {n.host_block for n in pc._spilled if n.host_block >= 0}
    return sorted(pages)


def _assert_kv_close(got, want):
    d = np.abs(got - want)
    assert got.shape == want.shape
    assert d.max() <= 1e-2 and np.median(d) <= 1e-5, (d.max(), np.median(d))


def _check_host_pages(je, te):
    pages = _live_host_pages(te)
    assert pages == _live_host_pages(je)
    for h in pages:
        a, b = te.host_page(h)
        _assert_kv_close(a.numpy(), np.asarray(je.h_k_pages[:, h]))
        _assert_kv_close(b.numpy(), np.asarray(je.h_v_pages[:, h]))
    return len(pages)


class Lockstep:
    """A JAX engine and a port engine (or two routers over them) stepped
    together; after every step their plans must move the same pages and
    their live host pages must hold the same payloads."""

    def __init__(self, jax_side, port_side, jax_engines, port_engines):
        self.sides = (jax_side, port_side)
        self.engines = (jax_engines, port_engines)
        self.plans = [[_spy(e) for e in es] for es in self.engines]
        self.reqs = ([], [])
        self.steps = self.host_checks = 0
        self.resumed = set()  # swapped in while decoding, not since preempted

    def add(self, prompt, max_new):
        for side, reqs, R in zip(self.sides, self.reqs,
                                 (JaxRequest, Request)):
            reqs.append(R(len(reqs), 0.0, list(prompt),
                          max_new_tokens=max_new))
            side.add_request(reqs[-1])

    def step(self):
        for side in self.sides:
            side.step()
        self.steps += 1
        for jp, tp, je, te in zip(*self.plans, *self.engines):
            assert len(jp) == len(tp)
            if not tp:
                continue
            got, want = _moves(tp[-1]), _moves(jp[-1])
            assert got == want, (self.steps, got, want)
            for rid, _, _ in got["chunks"]:
                assert rid not in self.resumed, \
                    f"request {rid} re-prefilled after its swap-in"
            self.resumed -= set(got["preempted"])
            self.resumed |= {r.request_id for r, _ in tp[-1].swap_in
                             if r.output}
            self.host_checks += _check_host_pages(je, te)

    def run(self, max_steps=2000):
        while any(s.has_work for s in self.sides):
            self.step()
            assert self.steps < max_steps, "did not drain"
        jreqs, treqs = self.reqs
        for a, b in zip(jreqs, treqs):
            assert b.full_output == a.full_output, b.request_id
            assert b.finish_reason == a.finish_reason
        return treqs

    def moved(self, key):
        """Requests in ``key`` lists over the port's run."""
        return [r.request_id for ps in self.plans[1] for p in ps
                for r in ([r for r, _ in getattr(p, key)]
                          if key in MOVES else getattr(p, key))]


def _assert_trace_ok(engines):
    for e in engines:
        trace = to_chrome_trace(e.trace.events())
        assert validate_trace_events(trace) == []
        assert validate_swap_balance(trace) == []


def _assert_drained(engines, pinned=False):
    """The device, host and pending ledgers empty (device pages but those a
    cluster's publication board still pins, where ``pinned``), and every
    decode slot free."""
    for e in engines:
        assert not e.slots
        assert sorted(e.free_slots) == list(range(e.ecfg.max_slots))
        a = e.allocator
        if e.prefix_cache is not None:
            e.prefix_cache.clear()
        assert pinned or a.num_free == a.num_blocks
        assert a.swapped_pages == 0 and a.pending_out_pages == 0


def _crunch_prompts(vocab, seed=2, n=2, plen=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen).tolist() for _ in range(n)]


# -- swap, speculative swap, auto + cost ---------------------------------------

MODES = {
    "swap": dict(swap_mode="swap"),
    "speculative": dict(swap_mode="swap", speculative_swap=True),
    "auto-cost": dict(swap_mode="auto", victim_policy="cost"),
}


def _crunch(mode):
    """The mode's engine knobs and (requests, prompt tokens, new tokens).
    ``auto`` swaps a victim only past 8 pages of computed tokens, so its
    two prompts are 60 tokens long on a 20-page pool; the others run the
    reference test's crunch."""
    kw = dict(CRUNCH, **MODES[mode])
    if mode == "auto-cost":
        return dict(kw, num_pages=20), (2, 60, 30)
    return kw, (2, 17, 20)


def _mode_run(setup, mode):
    kw, (n, plen, new) = _crunch(mode)
    je, te = _engines(setup, **kw)
    run = Lockstep(je, te, [je], [te])
    for p in _crunch_prompts(setup["jcfg"].vocab_size, n=n, plen=plen):
        run.add(p, new)
    reqs = run.run()
    return run, je, te, reqs


@pytest.mark.parametrize("setup", ["gqa", "mla"], indirect=True)
@pytest.mark.parametrize("mode", list(MODES))
def test_swap_modes_match_jax(setup, mode):
    """Each mode under the crunch: the same swap / issue / complete /
    cancel plans as the JAX engine, identical greedy tokens, the same host
    payloads, a valid trace and drained ledgers. ``swap`` mode recomputes
    nothing (no preemption); the speculative run issues copies early and
    resolves every issue once."""
    run, je, te, reqs = _mode_run(setup, mode)
    assert te.swapped_out == je.swapped_out == te.swapped_in > 0
    assert run.host_checks > 0
    if mode != "auto-cost":
        assert te.preemptions == 0 and all(r.preemptions == 0 for r in reqs)
    if mode == "speculative":
        issues = run.moved("swap_issue")
        assert issues
        assert len(run.moved("swap_complete")) + \
            len(run.moved("swap_cancel")) == len(issues)
    # cumulative counters; as in the reference, an iteration that computes
    # nothing (a swap-in alone) takes no snapshot
    names = ("swap_outs", "swap_ins", "swap_issues", "swap_cancels",
             "swapped_pages", "swap_pending_pages")
    rows = [[{k: r[k] for k in names} for r in e.metrics.rows()]
            for e in (je, te)]
    assert rows[1] == rows[0] and rows[1][-1]["swap_outs"] > 0
    _assert_trace_ok([te])
    _assert_drained([je, te])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v2-236b"])
@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_swap_round_trip_is_bit_exact(arch, mode):
    """bfloat16 pools: each swapped-out page's host copy equals the device
    page as it was before the swap-out, and the page it is swapped back
    into equals it too, bit for bit."""
    cfg = smoke_config(arch)
    if arch == "h2o-danube-1.8b":
        cfg = dataclasses.replace(cfg, sliding_window=None)
    kw, (n, plen, new) = _crunch(mode)
    te = PagedEngine(cfg, init_params(cfg, seed=1, device="cpu"),
                     EngineConfig(**kw), device="cpu")
    assert te.k_pages.dtype == te.h_k_pages.dtype == torch.bfloat16
    before = {}  # host page -> the device page's contents at swap-out
    sch = te.scheduler
    out_hooks = {k: getattr(sch, k) for k in
                 ("swap_out_hook", "swap_issue_hook")}
    swap_in = sch.swap_in_hook

    def wrap_out(hook):
        def out(pairs):
            for d, h in pairs:
                before[h] = (te.k_pages[:, d].clone(), te.v_pages[:, d].clone())
            hook(pairs)
            for d, h in pairs:
                for got, want in zip(te.host_page(h), before[h]):
                    assert torch.equal(got, want)
        return out

    def wrap_in(pairs):
        swap_in(pairs)
        for h, d in pairs:
            assert torch.equal(te.k_pages[:, d], before[h][0])
            assert torch.equal(te.v_pages[:, d], before[h][1])
            checked.append(h)

    checked = []
    for k, hook in out_hooks.items():
        setattr(sch, k, wrap_out(hook))
    sch.swap_in_hook = wrap_in
    reqs = [Request(i, 0.0, p, max_new_tokens=new) for i, p in
            enumerate(_crunch_prompts(cfg.vocab_size, n=n, plen=plen))]
    for r in reqs:
        te.add_request(r)
    te.run_to_completion()
    assert checked and te.swapped_in == te.swapped_out > 0
    assert all(len(r.full_output) == new for r in reqs)
    _assert_drained([te])


def test_host_pools_follow_the_device_pools(mla):
    """One page-major host pool per device pool, in its dtype: GQA (k, v)
    and MLA (ckv, krope); none without a host tier; not pinned on the
    CPU."""
    for setup in (mla, None):
        cfg = smoke_config("h2o-danube-1.8b") if setup is None \
            else setup["tcfg"]
        params = init_params(cfg, seed=0, device="cpu") if setup is None \
            else setup["tparams"]
        e = PagedEngine(cfg, params, EngineConfig(num_pages=8, page_size=PS,
                                                  host_pages=5),
                        device="cpu")
        for pool, host in ((e.k_pages, e.h_k_pages),
                           (e.v_pages, e.h_v_pages)):
            assert host.dtype == pool.dtype and not host.is_pinned()
            assert tuple(host.shape) == (5, pool.shape[0], *pool.shape[2:])
            assert host.is_contiguous()
        assert [tuple(t.shape) for t in e.host_page(4)] == \
            [(pool.shape[0], *pool.shape[2:]) for pool in (e.k_pages,
                                                           e.v_pages)]
    e = PagedEngine(cfg, params, EngineConfig(num_pages=8, page_size=PS),
                    device="cpu")
    assert e.h_k_pages is None and e.scheduler.swap_out_hook is None


# -- leased borrower, preemption budget ----------------------------------------

class Scripted:
    """Placement by a fixed list of instance indices."""

    def __init__(self, script):
        self.script = list(script)

    def choose(self, req, children):
        return self.script.pop(0)


def test_leased_borrower_is_sacrificed_not_swapped(gqa):
    """A zero-copy borrower on a tight instance in ``swap`` mode: its
    leading pages live on the creditor and its lease is repaid at
    eviction, so the scheduler sacrifices it (recompute) where it would
    swap a local request. Both clusters make the same plans and tokens,
    and the lease ledger ends empty."""
    rng = np.random.default_rng(23)
    vocab = gqa["jcfg"].vocab_size
    prefix = rng.integers(0, vocab, 2 * PS).tolist()
    prompts = [prefix + rng.integers(0, vocab, 3).tolist()
               for _ in range(2)] + \
        [rng.integers(0, vocab, 20).tolist(),
         prefix + rng.integers(0, vocab, 4).tolist()]
    kw = dict(page_size=PS, max_slots=2, host_pages=16, swap_mode="swap",
              enable_prefix_cache=True)
    engines = [[_engine(gqa, side, num_pages=pages, **kw)
                for pages in (32, 10)] for side in ("jax", "port")]
    sides = [cls(es, policy=Scripted([0, 0, 1, 1]), prefix_share=True,
                 share_mode="zero_copy", hot_threshold=1)
             for cls, es in zip((JaxRouter, RouterBackend), engines)]
    run = Lockstep(*sides, *engines)
    for p in prompts[:2]:  # the second hit makes the prefix hot
        run.add(p, 3)
        run.run()
    run.add(prompts[2], 30)
    run.add(prompts[3], 30)
    run.run()
    borrower = run.reqs[1][3]
    assert borrower.instance_id == 1 and borrower.num_cached_tokens == 2 * PS
    assert borrower.preemptions > 0 and borrower.swaps == 0
    assert 3 in run.moved("preempted") and 3 not in run.moved("swap_out")
    assert sides[1].leases_granted > 0
    for router in sides:
        assert not router.g.ledger
    _assert_trace_ok(engines[1])
    _assert_drained(engines[0] + engines[1], pinned=True)


def test_max_preemptions_drops_the_request(gqa):
    """``max_preemptions=0`` with ``auto`` swaps on short contexts (which
    sacrifice): the first victim is dropped as "preempted-dropped", alike
    in both engines, and its pages are freed."""
    je, te = _engines(gqa, **dict(CRUNCH, swap_mode="auto",
                                  max_preemptions=0))
    run = Lockstep(je, te, [je], [te])
    for p in _crunch_prompts(gqa["jcfg"].vocab_size, seed=4, n=3):
        run.add(p, 20)
    reqs = run.run()
    dropped = [r for r in reqs if r.finish_reason == "preempted-dropped"]
    assert dropped and te.preemptions >= len(dropped)
    _assert_trace_ok([te])
    _assert_drained([je, te])


# -- prefix-cache spill and the peer spill tier ----------------------------------

@pytest.mark.parametrize("setup", ["gqa", "mla"], indirect=True)
def test_prefix_spill_and_restore_match_jax(setup):
    """A finished request's prefix pages are cached; the cold leaf page is
    evicted with a spill budget, so it moves to a host page; a second
    request sharing the prefix restores it from host instead of
    recomputing. Spill and restore counts, the host payload, plans and
    tokens equal the JAX engine's, and the restored request's tokens equal
    a cold engine's (a port engine without a prefix cache). (Eviction is
    called directly, as in ``tests/test_swap.py``: under pool pressure the
    copied radix cache cannot evict past a spilled leaf, ROADMAP §3.)"""
    je, te = _engines(setup, num_pages=16, page_size=PS, max_slots=2,
                      host_pages=16, enable_prefix_cache=True,
                      cache_spill_pages=4)
    vocab = setup["jcfg"].vocab_size
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, vocab, 2 * PS).tolist()
    prompts = [prefix + rng.integers(0, vocab, n).tolist() for n in (4, 5)]
    run = Lockstep(je, te, [je], [te])
    run.add(prompts[0], 3)
    run.run()
    for e in (je, te):
        assert e.prefix_cache.evict(1) == 1
    assert _check_host_pages(je, te) == 1
    run.add(prompts[1], 4)
    run.run()
    pc, jpc = te.prefix_cache, je.prefix_cache
    assert pc.spilled_pages == jpc.spilled_pages == 1
    assert pc.restored_pages == jpc.restored_pages == 1
    assert run.reqs[1][1].num_cached_tokens == 2 * PS
    assert te.swapped_out == te.swapped_in == 0, "spills count apart"
    cold = PagedEngine(setup["tcfg"], setup["tparams"], EngineConfig(
        num_pages=16, page_size=PS, max_slots=2), device="cpu")
    r = Request(0, 0.0, prompts[1], max_new_tokens=4)
    cold.add_request(r)
    cold.run_to_completion()
    assert r.full_output == run.reqs[1][1].full_output
    _assert_trace_ok([te])
    _assert_drained([je, te])


def test_peer_spill_restores_through_two_port_engines(gqa):
    """``RouterBackend(peer_spill=True)`` over two port engines (the
    pattern of ``tests/test_swap.py::test_engine_peer_spill_restore_
    token_identity``): a cold prefix page of engine 0 is parked in engine
    1's free device memory through page payloads, restored on the next
    hit, and the loan repaid. The same happens in the JAX cluster, with
    the same tokens; the parked page's payload equals the JAX cluster's
    while it is parked."""
    kw = dict(num_pages=16, page_size=PS, max_slots=2, host_pages=16,
              enable_prefix_cache=True, cache_spill_pages=4)
    engines = [[_engine(gqa, side, **kw) for _ in range(2)]
               for side in ("jax", "port")]
    sides = [cls(es, policy=Scripted([0, 0]), prefix_share=True,
                 peer_spill=True)
             for cls, es in zip((JaxRouter, RouterBackend), engines)]
    rng = np.random.default_rng(5)
    vocab = gqa["jcfg"].vocab_size
    prefix = rng.integers(0, vocab, 2 * PS).tolist()
    run = Lockstep(*sides, *engines)
    run.add(prefix + rng.integers(0, vocab, 4).tolist(), 3)
    run.run()
    parked = []
    for es, router in zip(engines, sides):
        pc = es[0].prefix_cache
        pc.evict(1)  # park the cold leaf page on the neighbour
        assert pc.peer_spilled_pages == 1 and router.g.lent_by(1) == 1
        (node,) = [n for n in pc._spilled if n.peer_home == 1]
        parked.append([np.asarray(p[:, node.peer_block])
                       for p in (es[1].k_pages, es[1].v_pages)])
    for want, got in zip(*parked):
        _assert_kv_close(got, want)
    run.add(prefix + rng.integers(0, vocab, 4).tolist(), 3)
    reqs = run.run()
    assert reqs[1].num_cached_tokens == 2 * PS
    for es, router in zip(engines, sides):
        assert es[0].prefix_cache.peer_restored_pages == 1
        assert router.g.lent_by(1) == 0, "the loan is repaid on restore"
        es[0].prefix_cache.clear()
        assert es[1].allocator.num_used == 0
    _assert_trace_ok(engines[1])
    _assert_drained(engines[0] + engines[1])


# -- the launcher ----------------------------------------------------------------

def test_launcher_swaps_and_exports_a_trace(tmp_path, capsys):
    """``--host-pages`` with ``--swap-mode swap`` on a pool too small for
    its requests: the summary line counts the swaps, and the exported
    trace and metrics CSV are valid."""
    import json
    trace, csv_path = tmp_path / "t.json", tmp_path / "m.csv"
    stats = serve.main(["--reduced", "--device", "cpu", "--requests", "6",
                        "--rate", "1000", "--max-new", "40", "--pages", "12",
                        "--page-size", "8", "--slots", "4",
                        "--host-pages", "32", "--swap-mode", "swap",
                        "--speculative-swap", "--trace", str(trace),
                        "--metrics-csv", str(csv_path)])
    out = capsys.readouterr().out
    assert stats.n_finished == stats.n_requests == 6
    assert "host swap: " in out, out
    obj = json.loads(trace.read_text())
    assert validate_trace_events(obj) == [] and \
        validate_swap_balance(obj) == []
    assert any(e.get("name") == "swap_out" for e in obj["traceEvents"])
    assert "swap_outs" in csv_path.read_text().splitlines()[0]
