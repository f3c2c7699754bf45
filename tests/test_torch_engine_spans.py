"""The engine's own spans (``core/telemetry``): the tree a step records,
its clock against ``torch.profiler``'s, and what recording costs when it
is off. CPU only, no JAX: a smoke-width paper-opt-13b engine."""

import tracemalloc
from collections import defaultdict

import pytest
import torch

from repro_torch.bridge import init_params
from repro_torch.configs import smoke_config
from repro_torch.core.telemetry import (last_profiled, profiler_clock,
                                        to_chrome_trace,
                                        validate_trace_events)
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine
from repro_torch.serving.router import RouterBackend

CFG = smoke_config("paper-opt-13b")
# chunks of at most 24 tokens: the 40-token prompt takes two iterations
ECFG = dict(num_pages=64, page_size=8, max_slots=4, max_tokens_per_iter=24)
PROMPTS = [list(range(1, 41)), list(range(3, 12)), list(range(7, 20))]
CHILDREN = {"iteration": {"schedule", "chunk", "decode.inputs",
                          "decode.layers", "sample", "emit"},
            "chunk": {"chunk.inputs", "chunk.layers", "sample"},
            "sample": {"sample.launch", "sample.wait"}}
LEAVES = {"schedule", "chunk.inputs", "chunk.layers", "decode.inputs",
          "decode.layers", "sample.launch", "sample.wait", "emit",
          "deliver"}
# the slack of a float of epoch seconds (about 0.24 us) in a comparison
EPS = 1e-6


@pytest.fixture(scope="module")
def params():
    torch.manual_seed(0)
    return init_params(CFG, 0, device="cpu")


def _engine(params, **kw):
    return PagedEngine(CFG, params, EngineConfig(**ECFG, **kw), device="cpu")


def _serve(svc, n_polls=None):
    """Submit the prompts (the last as best-of-2) and poll, handing back
    chunks, until done or ``n_polls`` polls."""
    for i, p in enumerate(PROMPTS):
        svc.submit(p, SamplingParams(
            max_new_tokens=4, n=2 if i == 2 else 1,
            temperature=0.8 if i == 2 else 0.0, seed=5))
    polls = 0
    while svc.pending and (n_polls is None or polls < n_polls):
        svc.poll()
        polls += 1


def _spans(events):
    return {e.args["span"]: e for e in events if e.ph == "X"}


@pytest.fixture(scope="module")
def traced(params):
    engine = _engine(params, enable_telemetry=True)
    _serve(LLMService(engine))
    return engine, engine.trace.events()


def test_step_spans_nest_as_the_tree(traced):
    engine, events = traced
    spans = _spans(events)
    kids = defaultdict(list)
    for e in spans.values():
        assert e.cat == "engine" and e.dur >= 0
        parent = e.args["parent"]
        if parent is None:
            assert e.name in ("iteration", "deliver")
            continue
        p = spans[parent]
        kids[p.name].append(e.name)
        assert e.name in CHILDREN[p.name], (p.name, e.name)
        assert e.it == p.it  # a span carries its step's iteration
        assert p.ts - EPS <= e.ts and e.ts + e.dur <= p.ts + p.dur + EPS
        if e.name in LEAVES:
            assert not any(c.args["parent"] == e.args["span"]
                           for c in spans.values())
    iters = [e for e in events if e.name == "iteration"]
    assert [e.it for e in iters] == list(range(engine.iterations))
    for it in iters:
        children = sorted((c for c in spans.values()
                           if c.args["parent"] == it.args["span"]),
                          key=lambda c: c.ts)
        names = [c.name for c in children]
        assert names[0] == "schedule" and names[-1] == "emit", names
        assert set(it.args) == {"decode_rows", "chunks", "prefill_tokens",
                                "span", "parent"}
        assert it.args["chunks"] == names.count("chunk")
        if it.args["decode_rows"]:
            # the block tables built by the step, then copied by _decode
            assert names[-5:-1] == ["decode.inputs", "decode.inputs",
                                    "decode.layers", "sample"]
    for ch in (e for e in spans.values() if e.name == "chunk"):
        names = [c.name for c in sorted(
            (c for c in spans.values()
             if c.args["parent"] == ch.args["span"]), key=lambda c: c.ts)]
        # the last chunk samples the first token, and the fork's child
        # samples its own
        n_samples = (1 + (ch.rid == 2)) if ch.args["last"] else 0
        assert names == ["chunk.inputs", "chunk.layers"] + \
            ["sample"] * n_samples, (ch.args, names)
        assert ch.rid is not None
    for s in (e for e in spans.values() if e.name == "sample"):
        assert s.args["rows"] in (1, ECFG["max_slots"])
    assert any(e.name == "decode.inputs" and e.args["width"] >= 1
               for e in spans.values())
    # two chunks of the 40-token prompt, in two iterations
    assert [e.args["start"] for e in spans.values()
            if e.name == "chunk" and e.rid == 0] == [0, 24]
    assert kids["chunk"].count("chunk.layers") == engine.prefill_chunks


def test_decode_layers_say_whether_the_step_was_graphed(traced):
    """Each ``decode.layers`` span closes with ``graphed``: 0 on the CPU,
    where no step replays the piecewise graphs."""
    engine, events = traced
    layers = [e for e in events if e.name == "decode.layers"]
    assert len(layers) == engine.decode_steps > 0
    assert {e.args["graphed"] for e in layers} == {0}
    assert engine.graph_decode_steps == 0


def test_first_token_and_delivery_share_the_request_id(traced):
    engine, events = traced
    spans = _spans(events)
    first = {e.rid: e for e in events if e.name == "first_token"}
    delivered = {e.rid: e for e in events if e.name == "delivered"}
    # three prompts, the last forked into two samples
    assert sorted(first) == sorted(delivered) == [0, 1, 2, 3]
    assert sum(e.name == "first_token" for e in events) == 4
    assert sum(e.name == "delivered" for e in events) == 4
    for rid, ft in first.items():
        assert ft.cat == delivered[rid].cat == "req"
        assert delivered[rid].ts >= ft.ts
        # sampled inside the request's last chunk (the child's: inside its
        # parent's), after the sampling waited for its token
        owner = 2 if rid == 3 else rid
        last = [c for c in spans.values() if c.name == "chunk"
                and c.rid == owner and c.args["last"]]
        assert len(last) == 1 and last[0].it == ft.it
        assert last[0].ts <= ft.ts <= last[0].ts + last[0].dur + EPS
        waits = [w for w in spans.values() if w.name == "sample.wait"
                 and last[0].ts <= w.ts <= ft.ts]
        assert waits
        dl = [d for d in spans.values() if d.name == "deliver"
              and d.ts - EPS <= delivered[rid].ts <= d.ts + d.dur + EPS]
        assert len(dl) == 1 and dl[0].args["parent"] is None


def test_exported_spans_are_a_valid_trace(traced):
    engine, events = traced
    obj = to_chrome_trace(events)
    assert validate_trace_events(obj) == []
    ts = [e["ts"] for e in obj["traceEvents"] if e["ph"] == "X"]
    # microseconds of the Unix epoch
    assert all(1.5e15 < t < 4e15 for t in ts)


def test_telemetry_rows_follow_the_steps(traced):
    engine, _ = traced
    rows = engine.metrics.rows()
    assert len(rows) == engine.iterations
    assert rows[-1]["tokens"] == sum(map(len, PROMPTS)) + 4 * 4 - 4


def test_an_empty_plan_closes_its_iteration_and_takes_a_row(params):
    engine = _engine(params, enable_telemetry=True)
    assert engine.step(0.0) == []
    sched, it = engine.trace.events()
    assert it.name == "iteration" and it.args["parent"] is None
    assert sched.name == "schedule"
    assert sched.args["parent"] == it.args["span"]
    assert (it.args["decode_rows"], it.args["chunks"],
            it.args["prefill_tokens"]) == (0, 0, 0)
    assert engine.trace._open == []
    assert len(engine.metrics.rows()) == 1 and engine.iterations == 0


def test_recording_off_allocates_nothing_in_telemetry(params):
    engine = _engine(params)
    svc = LLMService(engine)
    _serve(svc, n_polls=2)  # the first chunk and first decode, untraced
    tracemalloc.start(32)
    try:
        _serve(svc)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = snap.filter_traces([tracemalloc.Filter(
        True, "*repro_torch/core/telemetry/*", all_frames=True)])
    assert sum(s.size for s in mine.statistics("filename")) == 0
    assert engine.recording is None and engine._profile_trace is None
    assert not svc.pending


@pytest.fixture(scope="module")
def profiled(params):
    engine = _engine(params)
    svc = LLMService(engine)
    _serve(svc, n_polls=3)
    before = engine.decode_steps + engine.prefill_chunks
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(svc)
    calls = engine.decode_steps + engine.prefill_chunks - before
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ops = [(ev.name, (start_ns + 1e3 * ev.time_range.start) / 1e9,
            (start_ns + 1e3 * ev.time_range.end) / 1e9)
           for ev in prof.events() if ev.name.startswith("aten::")]
    return engine, prof, ops, calls


def test_a_profiler_session_turns_recording_on(profiled):
    engine = profiled[0]
    tr = engine._profile_trace
    assert engine.trace is None and tr is not None
    assert last_profiled() is tr
    names = {e.name for e in tr.events()}
    assert {"iteration", "chunk", "decode.layers", "sample.wait",
            "deliver", "first_token", "delivered"} <= names
    # after the session no step records
    engine.step(0.0)
    assert engine.recording is None


def test_spans_enclose_the_ops_they_launch(profiled):
    """Moved by ``trace_start_ns``, the profile's aten ops fall inside the
    program's spans: every one inside an ``iteration``, each embedding
    lookup (``table[tokens]``, the first op of the layers) inside a
    ``*.layers`` span, and the copies to the host inside ``sample.wait``."""
    engine, _, ops, calls = profiled
    evs = engine._profile_trace.events()
    slack = 2e-6  # the profile's times are whole microseconds

    def inside(name, t0, t1):
        return any(e.ts - slack <= t0 and t1 <= e.ts + e.dur + slack
                   for e in evs if e.name == name)
    assert len(ops) > 100
    assert all(inside("iteration", s, e) for _, s, e in ops)
    waits = [w for w in evs if w.name == "sample.wait"]
    for w in waits:
        assert any(n in ("aten::to", "aten::_to_copy", "aten::copy_")
                   and w.ts - slack <= s and e <= w.ts + w.dur + slack
                   for n, s, e in ops), w
    layers = [e for e in evs if e.name.endswith(".layers")]
    assert len(layers) == calls
    lookups = [(s, e) for n, s, e in ops if n == "aten::index"]
    for lay in layers:
        assert any(lay.ts - slack <= s and e <= lay.ts + lay.dur + slack
                   for s, e in lookups), lay


def test_no_program_span_is_a_profiler_event(profiled):
    engine, prof = profiled[:2]
    mine = {e.name for e in engine._profile_trace.events()}
    assert not mine & {ev.name for ev in prof.events()}


def test_a_cluster_stamps_router_and_engines_on_one_clock(params):
    """Behind a router, the router's own track (placement) and each
    engine's spans, instants and metric rows all lie on the profiler's
    clock, inside the run's bounds."""
    engines = [_engine(params, enable_telemetry=True) for _ in range(2)]
    router = RouterBackend(engines)
    svc = LLMService(router)
    t0 = profiler_clock()
    _serve(svc)
    t1 = profiler_clock()
    events = router.trace_events()
    places = {e.rid: e for e in events if e.name == "place"}
    assert places and {e.instance for e in places.values()} == {2}
    assert {e.instance for e in events if e.name == "iteration"} == {0, 1}
    for e in events:
        assert t0 <= e.ts and e.ts + (e.dur or 0.0) <= t1, e
    for rid, pl in places.items():
        chunks = [e for e in events if e.name == "chunk" and e.rid == rid]
        assert all(pl.ts <= c.ts for c in chunks)
    rows = [r for m in router.metrics_timelines().values() for r in m]
    assert len(rows) == sum(e.iterations for e in engines)
    assert all(t0 <= r["ts"] <= t1 for r in rows)
