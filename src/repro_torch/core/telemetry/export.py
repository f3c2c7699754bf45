"""Exporters: Chrome/Perfetto trace-event JSON and metrics-timeline dumps.

Trace-event mapping (see the Trace Event Format spec the Chrome tools
consume): timestamps are microseconds; ``pid`` is the serving instance
(one process track per instance, named via ``M`` metadata); complete
(``X``) events carry ``dur``; per-request spans use async-nestable
``b``/``e`` pairs matched on (cat, id); counter (``C``) events render as
stacked area tracks. Open the output in https://ui.perfetto.dev or
``chrome://tracing``.

``validate_trace_events`` is the structural schema check shared by the
``tools/validate_trace.py`` CLI and the exporter golden tests.
"""

from __future__ import annotations

import csv
import json
from typing import Dict, Iterable, List, Optional

from .tracer import Event, PH_BEGIN, PH_COMPLETE, PH_COUNTER, PH_END, \
    PH_INSTANT

_S_TO_US = 1e6


def to_chrome_trace(events: Iterable[Event]) -> dict:
    """Convert tracer events to a trace-event JSON object (dict)."""
    out: List[dict] = []
    instances = set()
    for e in events:
        instances.add(e.instance)
        te: Dict[str, object] = {
            "name": e.name,
            "cat": e.cat,
            "ph": e.ph,
            "ts": e.ts * _S_TO_US,
            "pid": e.instance,
            "tid": 0,
        }
        if e.ph == PH_COMPLETE:
            te["dur"] = (e.dur or 0.0) * _S_TO_US
        elif e.ph == PH_INSTANT:
            te["s"] = "t"  # thread-scoped instant
        elif e.ph in (PH_BEGIN, PH_END):
            # async-nestable span keyed by request id
            te["id"] = e.rid if e.rid is not None else 0
        args: Dict[str, object] = dict(e.args) if e.args else {}
        if e.ph != PH_COUNTER:
            if e.rid is not None:
                args.setdefault("rid", e.rid)
            args.setdefault("iteration", e.it)
        if args:
            te["args"] = args
        out.append(te)
    # name the per-instance process tracks
    for inst in sorted(instances):
        out.append({
            "name": "process_name",
            "ph": "M",
            "pid": inst,
            "tid": 0,
            "ts": 0,
            "args": {"name": f"instance {inst}"},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(events: Iterable[Event], path: str) -> dict:
    """Write trace-event JSON to ``path``; returns the exported object."""
    obj = to_chrome_trace(events)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


# ---------------------------------------------------------------------------
# Metrics timelines


def _flatten_timelines(
        timelines: Dict[int, List[Dict[str, float]]]) -> List[Dict]:
    """One row stream across instances, with an ``instance`` column."""
    rows: List[Dict] = []
    for inst in sorted(timelines):
        for row in timelines[inst]:
            r = {"instance": inst}
            r.update(row)
            rows.append(r)
    return rows


def export_metrics_csv(timelines: Dict[int, List[Dict[str, float]]],
                       path: str) -> int:
    """Write per-iteration metric rows as CSV (union of columns, blank
    where a row lacks a metric). Returns the number of data rows."""
    rows = _flatten_timelines(timelines)
    lead = ["instance", "ts", "iteration"]
    keys = sorted({k for r in rows for k in r} - set(lead))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=lead + keys, restval="")
        w.writeheader()
        w.writerows(rows)
    return len(rows)


def export_metrics_json(timelines: Dict[int, List[Dict[str, float]]],
                        path: str) -> int:
    rows = _flatten_timelines(timelines)
    with open(path, "w") as f:
        json.dump(rows, f)
    return len(rows)


# ---------------------------------------------------------------------------
# Trace-event schema validation

_KNOWN_PH = {"X", "i", "I", "b", "e", "n", "B", "E", "C", "M", "s", "t",
             "f", "P"}


def validate_trace_events(obj: object) -> List[str]:
    """Structural validation of a trace-event JSON object.

    Returns a list of human-readable problems (empty ⇒ valid): top-level
    shape, required fields per event, known phase codes, non-negative
    durations, and async ``b``/``e`` balance per (cat, id, name).
    """
    errors: List[str] = []
    if isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level object lacks a 'traceEvents' list"]
    elif isinstance(obj, list):
        events = obj
    else:
        return ["trace must be a JSON object with 'traceEvents' or a list"]

    open_spans: Dict[tuple, int] = {}
    for i, e in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if not isinstance(ph, str) or ph not in _KNOWN_PH:
            errors.append(f"{where}: unknown or missing ph {ph!r}")
            continue
        if "name" not in e:
            errors.append(f"{where}: missing name")
        if ph != "M":
            if not isinstance(e.get("ts"), (int, float)):
                errors.append(f"{where}: missing numeric ts")
            if "pid" not in e:
                errors.append(f"{where}: missing pid")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)):
                errors.append(f"{where}: complete event missing dur")
            elif dur < 0:
                errors.append(f"{where}: negative dur {dur}")
        if ph in ("b", "e"):
            if "id" not in e:
                errors.append(f"{where}: async event missing id")
            else:
                key = (e.get("cat"), e.get("id"), e.get("name"))
                if ph == "b":
                    open_spans[key] = open_spans.get(key, 0) + 1
                else:
                    n = open_spans.get(key, 0)
                    if n <= 0:
                        errors.append(
                            f"{where}: async end without begin for {key}")
                    else:
                        open_spans[key] = n - 1
        if ph == "C" and not isinstance(e.get("args"), dict):
            errors.append(f"{where}: counter event missing args")
    for key, n in open_spans.items():
        if n != 0:
            errors.append(f"unclosed async span {key} (depth {n})")
    return errors


_SWAP_OUTCOMES = ("complete", "cancel", "orphaned")


def validate_swap_balance(obj: object) -> List[str]:
    """Check the host-swap invariants on an exported trace.

    Per request, ``sched.swap_out`` / ``sched.swap_in`` instants must
    alternate starting with an out: at any point in time a request is
    either device-resident (balance 0) or host-resident (balance 1).
    A trailing unmatched ``swap_out`` is legal — the request finished or
    was abandoned while swapped — so the final balance per rid may be 0
    or 1, never more.

    Overlapped (speculative) swap-outs add the ``swap.pending`` async
    span: every issue (``b``) must resolve in exactly one matching ``e``
    whose ``outcome`` is complete | cancel | orphaned — never two, never
    none — and while a request's pages are mid-flight it must do no work:
    no ``sched.admit``, ``sched.swap_in``, or prefill ``req.chunk`` may
    land strictly inside the span. Returns human-readable problems
    (empty ⇒ valid).
    """
    if isinstance(obj, dict):
        events = obj.get("traceEvents", [])
    elif isinstance(obj, list):
        events = obj
    else:
        return ["trace must be a JSON object with 'traceEvents' or a list"]
    swaps = []
    pending_open: Dict[object, float] = {}
    flights: Dict[object, List[tuple]] = {}  # rid -> [(issue_ts, end_ts)]
    activity: List[tuple] = []  # (ts, rid, cat.name)
    errors: List[str] = []
    for e in events:  # list order == emission order
        if not isinstance(e, dict):
            continue
        cat, name, ph = e.get("cat"), e.get("name"), e.get("ph")
        args = e.get("args") or {}
        ts = e.get("ts", 0.0)
        if cat == "sched" and name in ("swap_out", "swap_in"):
            swaps.append((ts, args.get("rid"), name))
        if (cat, name) in (("sched", "admit"), ("sched", "swap_in"),
                           ("req", "chunk")):
            activity.append((ts, args.get("rid"), f"{cat}.{name}"))
        if cat == "swap" and name == "pending":
            rid = e.get("id", args.get("rid"))
            if ph == "b":
                if rid in pending_open:
                    errors.append(f"rid {rid}: swap issue at ts={ts} while "
                                  f"a swap is already in flight")
                else:
                    pending_open[rid] = ts
            elif ph == "e":
                if rid not in pending_open:
                    errors.append(f"rid {rid}: swap resolution at ts={ts} "
                                  f"without an open issue")
                else:
                    flights.setdefault(rid, []).append(
                        (pending_open.pop(rid), ts))
                if args.get("outcome") not in _SWAP_OUTCOMES:
                    errors.append(
                        f"rid {rid}: swap resolution at ts={ts} has "
                        f"outcome {args.get('outcome')!r} (must be one of "
                        f"{'|'.join(_SWAP_OUTCOMES)})")
    for rid, ts in sorted(pending_open.items(), key=lambda kv: str(kv[0])):
        errors.append(f"rid {rid}: swap issued at ts={ts} never resolved")
    # a request whose pages are mid-flight does no work
    for ts, rid, what in activity:
        for t0, t1 in flights.get(rid, ()):
            if t0 < ts < t1:
                errors.append(f"rid {rid}: {what} at ts={ts} while its "
                              f"pages were in flight ({t0}..{t1})")
    balance: Dict[object, int] = {}
    for ts, rid, name in sorted(swaps, key=lambda s: s[0]):
        if rid is None:
            errors.append(f"sched.{name} at ts={ts} lacks a rid")
            continue
        b = balance.get(rid, 0)
        if name == "swap_out":
            if b != 0:
                errors.append(f"rid {rid}: swap_out at ts={ts} while "
                              f"already swapped out (balance {b})")
            balance[rid] = b + 1
        else:
            if b != 1:
                errors.append(f"rid {rid}: swap_in at ts={ts} without a "
                              f"prior swap_out (balance {b})")
            balance[rid] = b - 1
    for rid, b in sorted(balance.items(), key=lambda kv: str(kv[0])):
        if b not in (0, 1):
            errors.append(f"rid {rid}: final swap balance {b} "
                          f"(must be 0 or 1)")
    return errors
