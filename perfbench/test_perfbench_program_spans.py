"""The readers of the program's own spans (``metrics/_program.py`` and the
four metrics on it) on made-up spans and trace tuples, and on a traced
run of the harness on the CPU."""

import types
from pathlib import Path

import pytest

from perfbench import tiny
from perfbench.harness import Bench, run_cell
from perfbench.metrics import _program as P
from perfbench.profile import Trace
from repro_torch.core.telemetry import Tracer

HERE = Path(__file__).resolve().parent
NEW = ("engine.sync_wait_pct", "device.idle_launch_ms_per_iter",
       "device.idle_host_ms_per_iter", "engine.first_token_hold_ms")
T0 = 1000.0  # the program's clock; the trace's is 999 s behind


def _two_steps():
    """A prefill step (one last chunk of request 7) and a decode step, each
    followed by a delivery, recorded through a tracer on a scripted clock:
    (name, +1 enter / -1 exit / 0 instant, time after ``T0``)."""
    script = [
        ("iteration", 1, .10), ("schedule", 1, .11), ("", -1, .12),
        ("chunk", 1, .12), ("chunk.inputs", 1, .12), ("", -1, .13),
        ("chunk.layers", 1, .13), ("", -1, .30),
        ("sample", 1, .30), ("sample.launch", 1, .30), ("", -1, .31),
        ("sample.wait", 1, .31), ("", -1, .35), ("", -1, .35),
        ("first_token", 0, .35), ("", -1, .36),
        ("emit", 1, .36), ("", -1, .38), ("", -1, .40),
        ("deliver", 1, .41), ("delivered", 0, .42), ("", -1, .43),
        ("iteration", 1, .50), ("schedule", 1, .50), ("", -1, .51),
        ("decode.inputs", 1, .51), ("", -1, .53),
        ("decode.layers", 1, .53), ("", -1, .70),
        ("sample", 1, .70), ("sample.launch", 1, .70), ("", -1, .71),
        ("sample.wait", 1, .71), ("", -1, .80), ("", -1, .80),
        ("emit", 1, .80), ("", -1, .82), ("", -1, .85),
        ("deliver", 1, .86), ("", -1, .87),
    ]
    times = iter([T0 + t for _, _, t in script])
    tr = Tracer(clock=lambda: next(times))
    for name, kind, _ in script:
        if kind == 1:
            tr.enter("engine", name, rid=7 if name == "chunk" else None,
                     root=name in ("iteration", "deliver"))
        elif kind == -1:
            tr.exit()
        else:
            tr.instant("req", name, rid=7)
    return tr.events()


def _trace(ops):
    spans = [("pb.window", 1.0, 2.0), ("pb.engine.step", 1.10, 1.405),
             ("pb.engine.step", 1.50, 1.855)]
    return Trace(ops, spans, 1.0, 2.0, iterations=2)


# device busy 1.15-1.25 (in chunk.layers), 1.30-1.33 (the sampling),
# 1.55-1.72 and 1.72-1.79 (decode)
OPS = [("gemm", 1.15, 1.25, 1.14), ("topk", 1.30, 1.33, 1.305),
       ("gemm", 1.55, 1.72, 1.54), ("Memcpy DtoH", 1.72, 1.79, 1.715)]


@pytest.fixture
def run(monkeypatch):
    events = _two_steps()
    monkeypatch.setattr(P, "kept_events", lambda: events)
    return types.SimpleNamespace(trace=_trace(OPS))


def _read(name, run):
    return Bench(HERE.parent).reader(name)(run)


def test_the_anchor_matches_iterations_to_the_steps_around_them():
    iters = [(5.0, 5.1), (7.0, 7.3), (1000.10, 1000.40), (1000.50, 1000.85)]
    steps = [(1.099, 1.405), (1.501, 1.855)]
    off, res = P.anchor(iters, steps)
    # the run of iterations whose differences agree: the last two
    assert off == pytest.approx(-999.0)
    assert res == [pytest.approx(-0.001), pytest.approx(0.001)]
    assert P.anchor(iters[:1], steps) is None
    assert P.anchor(iters, []) is None


def test_a_program_is_placed_on_the_trace_clock(run):
    prog = P.program(run)
    assert prog.residuals == [pytest.approx(0.0)] * 2
    first = [s for s in prog.spans if s[0] == "iteration"][0]
    assert first[1:3] == (pytest.approx(1.10), pytest.approx(1.40))
    assert ("first_token", 7, pytest.approx(1.35)) in prog.instants
    # a traced run without a trace: nothing
    assert P.program(types.SimpleNamespace(trace=None)) is None


def test_innermost_span_at_each_moment():
    # an outer span, a child opening at the same instant, a sibling
    spans = [("a", 0.0, 1.0, 1), ("b", 0.0, 0.4, 2), ("c", 0.4, 0.6, 3)]
    assert P.innermost(spans) == [(0.0, 0.4, "b"), (0.4, 0.6, "c"),
                                  (0.6, 1.0, "a")]


def test_a_gap_is_split_across_the_spans_it_overlaps(run):
    idle = {k: v for k, v in P.idle_by_span(P.program(run),
                                            run.trace).items()
            if v > 1e-9}  # the clock's rounding where a span meets an op
    # the gap 1.33-1.55 began in sample.wait but crosses the rest of the
    # first step, its delivery and the second step's inputs
    want = {None: .10 + .01 + .07 + .01 + .13, "iteration": .01 + .02 + .03,
            "schedule": .01 + .01, "chunk.inputs": .01,
            "chunk.layers": .02 + .05, "sample.wait": .02 + .01,
            "chunk": .01, "emit": .02 + .02, "deliver": .02 + .01,
            "decode.inputs": .02, "decode.layers": .02}
    assert idle == {k: pytest.approx(v) for k, v in want.items()}
    assert sum(idle.values()) == pytest.approx(
        run.trace.window_s - run.trace.busy_s)
    # outside in, the whole gap went to the span open when it began
    assert dict(Trace(OPS, [("pb.window", 1.0, 2.0),
                            ("pb.sample", 1.30, 1.35)], 1.0, 2.0,
                      2).gaps_by_span())["sample"] == pytest.approx(.22)


def test_the_four_readers_on_made_up_spans(run):
    got = {name: _read(name, run) for name in NEW}
    # sample.wait 0.04 + 0.09 s of iterations 0.30 + 0.35 s
    assert got["engine.sync_wait_pct"] == pytest.approx(20.0)
    # launch idle 0.09 s, the rest but sample.wait's 0.03 s: 0.51 s
    assert got["device.idle_launch_ms_per_iter"] == pytest.approx(45.0)
    assert got["device.idle_host_ms_per_iter"] == pytest.approx(255.0)
    assert got["engine.first_token_hold_ms"] == pytest.approx(70.0)
    c = P.checks(run)
    assert c["split_error_pct"] == pytest.approx(0.0, abs=1e-9)
    assert c["wait_idle_pct"] == pytest.approx(100 * .03 / .13)
    assert c["steps_matched"] == 2


def test_readers_give_none_without_program_spans(monkeypatch):
    monkeypatch.setattr(P, "kept_events", lambda: None)
    run = types.SimpleNamespace(trace=_trace(OPS))
    assert [_read(name, run) for name in NEW] == [None] * 4
    assert [_read(name, types.SimpleNamespace(trace=None))
            for name in NEW] == [None] * 4


def test_idle_readers_give_none_without_device_operations(run):
    run.trace = _trace([])
    assert _read("device.idle_launch_ms_per_iter", run) is None
    assert _read("device.idle_host_ms_per_iter", run) is None
    assert _read("engine.sync_wait_pct", run) == pytest.approx(20.0)


def test_a_traced_run_reads_the_program_spans(tmp_path):
    """On the CPU the profile has no device operations: the program's
    counters read, the device's idle split does not."""
    root = tiny.tiny_root(tmp_path, confs=(tiny.DENSE,))
    rec = {}
    out = run_cell(root, "tiny-dense.tiny", 2 ** 31 + 99, 1.0, True,
                   device="cpu", log=lambda *a: None, record=rec)
    assert out["correct"], out["check"]
    m = out["metrics"]
    assert 0 < m["engine.sync_wait_pct"]["value"] < 100
    assert m["engine.first_token_hold_ms"]["value"] > 0
    assert "device.idle_launch_ms_per_iter" not in m
    prog = P.program(rec["run"])
    assert len(prog.residuals) >= rec["run"].trace.iterations > 0
