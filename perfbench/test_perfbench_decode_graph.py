"""``engine.decode_graph_pct`` on made-up program spans: the share of the
stretch's ``decode.layers`` spans that carry ``graphed`` 1, nothing where
they carry no ``graphed`` (a program without the graphed path)."""

import types
from pathlib import Path

import pytest

from perfbench.harness import Bench
from perfbench.metrics import _program as P
from perfbench.profile import Trace
from repro_torch.core.telemetry import Tracer

HERE = Path(__file__).resolve().parent
T0 = 1000.0  # the program's clock; the trace's is 999 s behind
STARTS = (0.0, 0.1, 0.23, 0.33)  # each iteration's, after T0


def _steps(flags):
    """One decode iteration a flag, at ``STARTS`` on a scripted clock,
    each ``decode.layers`` span closed with ``graphed`` = the flag (None:
    no such argument); the last iteration falls after the stretch."""
    times = iter(T0 + t + dt for t in STARTS
                 for dt in (0.0, 0.01, 0.05, 0.06))
    tr = Tracer(clock=lambda: next(times))
    for flag in flags:
        tr.enter("engine", "iteration", root=True)
        tr.enter("engine", "decode.layers")
        tr.exit(**({} if flag is None else {"graphed": flag}))
        tr.exit()
    return tr.events()


@pytest.mark.parametrize("flags,want", [
    ((1, 1, 1, 0), 100.0),
    ((1, 0, 0, 1), 100.0 / 3),
    ((0, 0, 0, 0), 0.0),
    ((None, None, None, None), None),
])
def test_the_share_of_graphed_decode_steps(monkeypatch, flags, want):
    events = _steps(flags)
    monkeypatch.setattr(P, "kept_events", lambda: events)
    steps = [("pb.engine.step", 1.0 + t, 1.06 + t) for t in STARTS[:3]]
    run = types.SimpleNamespace(trace=Trace(
        [], [("pb.window", 0.99, 1.28)] + steps, 0.99, 1.28, iterations=3))
    got = Bench(HERE.parent).reader("engine.decode_graph_pct")(run)
    assert got == (None if want is None else pytest.approx(want))
