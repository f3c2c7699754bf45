"""The closed-loop generator: the same seed gives the same requests, every
length lies within its clips, every block of ``strata`` requests holds one
length from each band, and a run keeps every session's request out; a
request that fails counts in ``failed`` and in the tail of TTFT."""

import json
import math
import types
from pathlib import Path

import pytest

from perfbench import tiny
from perfbench.harness import Bench, tally
from perfbench.loops.closed import Loop, lognormal_quantile
from perfbench.metrics import _yardstick as Y

HERE = Path(__file__).resolve().parent
CHAT = json.loads((HERE / "traffic" / "chat64.json").read_text())
SEED = 2 ** 31 + 12345


def _sends(seed, n, spec=CHAT):
    loop = Loop(spec, seed, 50272)
    out = loop.start(0.0)
    while len(out) < n:
        out += loop.on_reply(len(out) % spec["sessions"], 1.0)
    return out[:n]


def test_same_seed_same_requests():
    a, b = _sends(SEED, 200), _sends(SEED, 200)
    assert [(s.prompt, s.max_new_tokens, s.session, s.at) for s in a] == \
        [(s.prompt, s.max_new_tokens, s.session, s.at) for s in b]
    c = _sends(SEED + 1, 200)
    assert [s.prompt for s in a] != [s.prompt for s in c]


def test_lengths_within_clips_and_ids_within_vocab():
    for s in _sends(SEED, 500):
        assert 32 <= len(s.prompt) <= 1536
        assert 16 <= s.max_new_tokens <= 384
        assert all(0 <= t < 50272 for t in s.prompt)


def test_every_block_holds_each_band_once():
    n = CHAT["strata"]
    spec = dict(CHAT, output=dict(CHAT["output"]))
    loop = Loop(spec, SEED, 100)
    lens = [loop._lengths(k) for k in range(4 * n)]
    for b in range(4):
        block = lens[b * n:(b + 1) * n]
        for which, key in ((0, "prompt"), (1, "output")):
            got = sorted(x[which] for x in block)
            edges = [spec[key]["min"]] + \
                [lognormal_quantile(spec[key], i / n) for i in range(1, n)] \
                + [spec[key]["max"]]
            for i, v in enumerate(got):
                assert edges[i] <= v <= edges[i + 1]


def test_other_seeds_send_the_same_sizes_in_another_order():
    n = CHAT["strata"]
    a = [Loop(CHAT, s, 100)._lengths(n - 1) for s in (1, 2)]
    med = lognormal_quantile(CHAT["prompt"], 0.5)
    for seed in (SEED, SEED + 7):
        loop = Loop(CHAT, seed, 100)
        lens = sorted(loop._lengths(k)[0] for k in range(n))
        assert lens[n // 2 - 1] <= med <= lens[n // 2 + 1]
    assert a[0] != a[1]


def test_first_requests_staggered_and_shortened():
    loop = Loop(CHAT, SEED, 100)
    first = loop.start(0.0)
    assert len(first) == CHAT["sessions"]
    ats = [s.at for s in first]
    assert ats == sorted(ats) and ats[0] == 0.0
    assert ats[-1] == pytest.approx(CHAT["stagger_s"] * 63 / 64)
    assert first[0].max_new_tokens == CHAT["output"]["min"]


def test_closed_loop_keeps_every_session_out(tmp_path):
    root = tiny.tiny_root(tmp_path)
    rec = {}
    from perfbench.harness import run_cell
    out = run_cell(root, "tiny-dense.tiny", SEED, 1.0, False, device="cpu",
                   record=rec, log=lambda *a: None)
    run = rec["run"]
    sessions = tiny.TRAFFIC["sessions"]
    polls = run.window_polls()
    assert len(polls) >= 3
    for p in polls:
        out_now = [c for c in run.clients
                   if c.sent <= p.t0 and (c.done is None or c.done > p.t0)]
        assert len(out_now) == sessions
        assert len({c.session for c in out_now}) == sessions
    assert out["attempted"] > 0 and out["failed"] == 0


def test_failed_request_counts_in_failed_and_in_the_tail():
    ok = [types.SimpleNamespace(sent=1.0 + i, tokens=[1.5 + i], failed=False)
          for i in range(9)]
    bad = types.SimpleNamespace(sent=5.0, tokens=[5.1], failed=True)
    unserved = types.SimpleNamespace(sent=6.0, tokens=[], failed=False)
    late = types.SimpleNamespace(sent=20.0, tokens=[], failed=False)
    assert tally(ok + [bad, unserved, late], 0.0, 10.0) == (11, 2)
    ttft = Y.ttfts(ok + [bad, unserved], 0.0, 10.0)
    assert sorted(ttft)[-2:] == [math.inf, math.inf]
    assert Y.percentile(ttft, 90) == math.inf
    assert Y.percentile(Y.ttfts(ok, 0.0, 10.0), 90) == pytest.approx(0.5)


def test_traffic_files_name_a_loop_that_exists():
    bench = Bench(HERE.parent)
    for cell in bench.doc["workloads"]:
        spec = bench.traffic(cell["traffic"])
        assert hasattr(bench.loop(spec["loop"]), "Loop")
