"""One run of one cell of ``BENCHMARK.json``.

Everything a cell names is found by that name, in files of its own:

* the configuration: the ``file`` its entry in ``configs`` gives (widths
  as the public ``config.json`` names them, the port's arch and the
  changes to it, the engine's geometry, the reference, the check's limit);
* the traffic mix: ``perfbench/traffic/<traffic>.json``, driven by the
  generator ``perfbench/loops/<loop>.py`` that the mix names;
* each per-layer metric: ``perfbench/metrics/<name>.py``, whose ``read(run)``
  returns the number or None where it finds nothing to read;
* the reference: ``perfbench/reference/<reference>.py``.

A run: the weights drawn on the device from the seed, the port's
``PagedEngine`` built from the configuration and warmed up on one prompt
of each power-of-two length the traffic sends, the engine's thread pinned
as the configuration's ``host`` key says (:mod:`perfbench.host`), the
traffic started and run for its warm-up, then the window of ``seconds``:
every request goes through ``LLMService.submit`` and ``LLMService.poll``,
and the client stamps each token when ``poll`` hands it back. After the
window no new request is sent, and the service is polled until every
request sent in the window has its first token (a minute at most). Then
the device's memory peak is read, the engine freed, and the served tokens
checked against the reference (:mod:`perfbench.check`).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from perfbench import check as chk
from perfbench import host
from perfbench.metrics import _yardstick as Y

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 60.0  # the longest wait for a first token after the window


def _load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def _module_from(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.doc = _load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / "perfbench"

    def cell(self, name: str) -> dict:
        for c in self.doc["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return _load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(self.dir / "traffic" / f"{name}.json")

    def loop(self, kind: str):
        return _module_from(self.dir / "loops" / f"{kind}.py",
                            f"perfbench_loop_{kind}")

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones
        without the trace, the per-layer ones with it, each where its
        ``workloads`` holds the cell (or it has none)."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        mod = _module_from(self.dir / "metrics" / f"{metric}.py",
                           "perfbench_metric_" + metric.replace(".", "_")
                           .replace("-", "_"))
        return mod.read


@dataclasses.dataclass
class Client:
    """One request as its client saw it."""

    rid: int
    session: int
    prompt: List[int]
    max_new: int
    sent: float
    req: object = None  # the service's Request (queue time)
    tokens: List[float] = dataclasses.field(default_factory=list)
    out: List[int] = dataclasses.field(default_factory=list)
    done: Optional[float] = None
    failed: bool = False


@dataclasses.dataclass
class Poll:
    t0: float
    t1: float
    chunks: int  # prefill chunks the iteration ran
    decodes: int  # decode steps (0 or 1)
    delivered: int  # tokens handed back
    work: list  # traced runs: ("chunk", start, length) / ("decode", lens)
    profiled: bool = False


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    conf: dict
    traffic: dict
    t_open: float
    t_close: float
    clients: List[Client]
    polls: List[Poll]
    trace: object = None  # perfbench.profile.Trace in a traced run
    calls: Optional[dict] = None  # the kernels' recorded calls

    def window_polls(self, include_profiled: bool = False) -> List[Poll]:
        return [p for p in self.polls
                if self.t_open <= p.t0 and p.t1 <= self.t_close
                and (include_profiled or not p.profiled)]


def port_config(conf: dict):
    """The port's ``ArchConfig`` for a configuration file: the port's arch
    with the file's changes, every width checked against the file."""
    from repro_torch.configs import get_config
    port = conf["port"]
    cfg = dataclasses.replace(get_config(port["arch_id"]),
                              **port.get("replace", {}))
    for field, key in port["equal"].items():
        if getattr(cfg, field) != conf[key]:
            raise ValueError(f"{conf['name']}: the port's {field} is "
                             f"{getattr(cfg, field)!r}, the file's {key} "
                             f"{conf[key]!r}")
    return cfg


def reference(conf: dict):
    return importlib.import_module(f"perfbench.reference.{conf['reference']}")


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _pow2_lengths(hi: int) -> List[int]:
    """8, 16, ... below ``hi``, then ``hi``."""
    out, n = [], 8
    while n < hi:
        out.append(n)
        n *= 2
    return out + [hi]


class _Clock:
    def __init__(self, t_start: float):
        self.t_start = t_start

    def __call__(self) -> float:
        return time.perf_counter() - self.t_start


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, *, device="cuda", t_start: Optional[float] = None,
             control: bool = False, hooks: Optional[Callable] = None,
             log=None, record: Optional[dict] = None) -> dict:
    """One run; returns the result line as a dict (with ``check`` last).
    ``hooks(engine)`` may change the engine before the traffic (the tests'
    planted faults). ``control`` also reads the control's numbers and
    judges them by the configuration's limits (``control_correct``).
    ``record["run"]`` receives the :class:`Run` the metrics read."""
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.api import FINISH_DROPPED, LLMService, \
        SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    clock = _Clock(time.perf_counter() if t_start is None else t_start)
    bench = Bench(root)
    cell = bench.cell(cell_name)
    conf = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    Loop = bench.loop(traffic["loop"]).Loop
    cfg = port_config(conf)
    ref = reference(conf)
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    weights = ref.make_weights(conf, seed, cfg.torch_dtype, dev)
    log(f"perfbench: weights drawn at {clock():.1f} s")
    engine = PagedEngine(cfg, weights, EngineConfig(**conf["engine"],
                                                    seed=seed), device=dev)
    if hooks is not None:
        hooks(engine)
    spans = None
    if trace:
        from perfbench.spans import Spans
        spans = Spans()
        spans.install(engine_mod, engine)
    loop = Loop(traffic, seed, conf["vocab_size"])

    # warm-up: one prompt of each power-of-two length up to the longest
    # the traffic sends (within an iteration's budget), two tokens each
    longest = min(traffic["prompt"]["max"],
                  conf["engine"]["max_tokens_per_iter"])
    warm = LLMService(engine)
    warm.generate([[1] * n for n in _pow2_lengths(longest)],
                  SamplingParams(max_new_tokens=2))
    del warm
    log(f"perfbench: engine warmed up at {clock():.1f} s")
    if trace:
        _profiler_warm(on_card)
        spans.take_work()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    # what set-up made stays: later collections need not walk it
    gc.collect()
    gc.freeze()
    pinned = host.pin(conf.get("host", {}))

    svc = LLMService(engine)
    clients: Dict[int, Client] = {}
    polls: List[Poll] = []
    greedy = dict(temperature=0.0, eos_token=None)
    t_traffic = clock()
    t_open = t_traffic + float(traffic["warmup_s"])
    t_close = t_open + seconds
    queue = sorted(loop.start(t_traffic), key=lambda s: s.at)
    prof = None
    prof_lo = t_open + (seconds - float(traffic["profile_s"])) / 2
    prof_hi = prof_lo + float(traffic["profile_s"])
    prof_iters = [0, 0]
    win_span = None

    def send(s, now):
        rid = svc.submit(s.prompt, SamplingParams(
            max_new_tokens=s.max_new_tokens, **greedy), arrival_time=now)
        clients[rid] = Client(rid, s.session, s.prompt, s.max_new_tokens,
                              now, req=svc._live[rid].req)

    sending = True
    while True:
        now = clock()
        if sending and now >= t_close:
            sending = False
        if not sending and _answered(clients, t_open, t_close):
            break
        if not sending and now > t_close + DRAIN_S:
            break
        while sending and queue and queue[0].at <= now:
            send(queue.pop(0), now)
        if trace:
            if prof is None and prof_iters[0] == 0 and now >= prof_lo:
                prof = _profiler_start(on_card)
                win_span = torch.profiler.record_function("pb.window")
                win_span.__enter__()
                prof_iters[0] = engine.iterations
                spans.recording = True
            elif prof is not None and prof_iters[1] == 0 and now >= prof_hi:
                spans.recording = False
                prof_iters[1] = engine.iterations
                win_span.__exit__(None, None, None)
                if on_card:
                    torch.cuda.synchronize(dev)
                prof.__exit__(None, None, None)
        c0, d0 = engine.prefill_chunks, engine.decode_steps
        t0 = clock()
        with torch.profiler.record_function("pb.poll") if trace \
                else _nothing():
            chunks = svc.poll(t0)
        t1 = clock()
        delivered = 0
        for ch in chunks:
            cl = clients.get(ch.request_id)
            if cl is None:
                continue
            cl.tokens.extend([t1] * len(ch.token_ids))
            cl.out.extend(ch.token_ids)
            delivered += len(ch.token_ids)
            if ch.finished:
                cl.done = t1
                cl.failed = ch.finish_reason == FINISH_DROPPED
                if sending:
                    for s in loop.on_reply(cl.session, t1):
                        queue.append(s)
                    queue.sort(key=lambda s: s.at)
        polls.append(Poll(t0, t1, engine.prefill_chunks - c0,
                          engine.decode_steps - d0, delivered,
                          spans.take_work() if trace else [],
                          profiled=prof is not None and prof_iters[1] == 0))
    if trace and prof is not None and prof_iters[1] == 0:
        spans.recording = False
        prof_iters[1] = engine.iterations
        win_span.__exit__(None, None, None)
        prof.__exit__(None, None, None)

    host.unpin(pinned)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"perfbench: window {t_open:.1f}-{t_close:.1f} s, drained at "
        f"{clock():.1f} s, {engine.iterations} iterations, "
        f"{engine.preemptions} preemptions, peak {peak / 2**30:.2f} GiB")
    if spans is not None:
        spans.uninstall()
    del svc, engine
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    attempted, unanswered = tally(clients.values(), t_open, t_close)
    finished = [c for c in clients.values()
                if c.done is not None and c.done >= t_open and not c.failed]
    short = sum(1 for c in finished if len(c.out) != c.max_new)
    bad = chk.served_ok(finished, conf["vocab_size"])
    picked = chk.sample(finished, seed, conf["check"]["sample_tokens"])
    numbers = {
        "unanswered": {"value": unanswered, "limit": 0},
        "short_replies": {"value": short, "limit": 0},
        "bad_tokens": {"value": int(bad is not None), "limit": 0},
    }
    control_read, compared, gaps_all = None, 0, {}
    served = {}
    if bad is None and picked:
        g = chk.gaps(ref, conf, weights, picked, control=control)
        served = chk.readings(g["served"])
        compared = len(g["served"])
        gaps_all = g
        if control:
            control_read = chk.readings(g["control"])
    for name, limit in conf["check"]["limits"].items():
        numbers[name] = {"value": served.get(name, math.inf), "limit": limit}
    if control:
        # the control judged as the program is, by the same limits
        control_numbers = {
            name: {"value": (control_read or {}).get(name, math.inf),
                   "limit": limit}
            for name, limit in conf["check"]["limits"].items()}
    del weights
    log(f"perfbench: checked {compared} tokens at {clock():.1f} s")
    leaked = forbidden_modules()

    run = Run(cell, conf, traffic, t_open, t_close, list(clients.values()),
              polls)
    if record is not None:
        record["run"] = run
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from perfbench import profile as pf
        run.calls = spans.calls
        if prof is not None:
            run.trace = pf.extract(prof, prof_iters[1] - prof_iters[0])
            log(f"perfbench: trace read at {clock():.1f} s")
        if run.trace is not None:
            extra, breakdown = pf.result_fields(run.trace)
            device_info.update(extra)
        else:
            device_info.update(busy_s=0.0, window_s=0.0)
    metrics = {}
    e2e = {} if trace else dict(Y.end_to_end(run.clients, t_open, t_close),
                                setup_s=t_open)
    for m in bench.metrics(cell_name, trace):
        value = bench.reader(m["name"])(run) if trace else e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": chk.verdict(numbers),
        "attempted": attempted,
        "failed": unanswered,
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["tokens_compared"] = compared
    out["served_readings"] = served
    if control:
        out["control_readings"] = control_read
        out["control_correct"] = chk.verdict(control_numbers)
    if record is not None:
        record["gaps"] = gaps_all
    out["leaked_modules"] = leaked
    out["check"] = numbers
    return out


def tally(clients, t_open: float, t_close: float):
    """(requests sent in the window, those of them that failed or had no
    first token)."""
    sent = [c for c in clients if t_open <= c.sent < t_close]
    return len(sent), sum(1 for c in sent if c.failed or not c.tokens)


def _answered(clients, t_open, t_close) -> bool:
    return all(c.tokens or c.failed for c in clients.values()
               if t_open <= c.sent < t_close)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _activities(on_card: bool):
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])


def _profiler_start(on_card: bool):
    prof = torch.profiler.profile(activities=_activities(on_card))
    prof.__enter__()
    return prof


def _profiler_warm(on_card: bool) -> None:
    """Start and stop the profiler once in set-up: its first start
    initialises the device's tracing, which must not fall in the window."""
    with torch.profiler.profile(activities=_activities(on_card)):
        torch.zeros(1, device="cuda" if on_card else "cpu").add_(1)
