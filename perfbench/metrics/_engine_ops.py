"""Device time inside the program's own spans: the operations a traced
run's device ran, each attributed to the spans of the program that were
open on the host when the runtime call that launched it was made.

The program's spans (``repro_torch.core.telemetry``, read through
:mod:`perfbench.metrics._program`) are placed on the trace's clock by the
anchor there; here each span of one name keeps the union of the device
intervals of the operations launched inside it, as
``profile.Trace.span_device_s`` does for the benchmark's own ``pb.*``
spans. A program that records no such spans gives None.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import List, Optional, Tuple

from perfbench.metrics import _program as P
from perfbench.metrics import _yardstick as Y


def spans(run, name: str) -> Optional[List[Tuple[float, float, dict]]]:
    """(start, end, args) of each of the program's ``name`` spans that
    starts inside the profiled stretch, on the trace's clock; None where
    the run has no placed program spans or none of that name."""
    prog = P.program(run)
    if prog is None:
        return None
    args = {e.args["span"]: e.args for e in P.kept_events()
            if e.ph == "X" and e.name == name}
    lo, hi = run.trace.lo, run.trace.hi
    out = [(s, e, args[sid]) for n, s, e, sid in prog.spans
           if n == name and lo <= s < hi and sid in args]
    return out or None


def device_s(trace, placed) -> List[float]:
    """Per span of ``placed`` ((start, end, args)), the seconds of the
    union of the device operations launched while it was open."""
    launched = sorted((t, s, e) for _, s, e, t in trace.ops if t is not None)
    times = [x[0] for x in launched]
    out = []
    for s0, s1, _ in placed:
        i, j = bisect_left(times, s0), bisect_right(times, s1)
        out.append(Y.union_s(((s, e) for _, s, e in launched[i:j]),
                             -float("inf"), float("inf")))
    return out


def elem_bytes(conf) -> int:
    """Bytes of an element of the configuration's serving type."""
    return {"bfloat16": 2, "float16": 2, "float32": 4}[conf["torch_dtype"]]
