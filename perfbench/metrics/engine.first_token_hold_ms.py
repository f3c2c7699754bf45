"""Mean ms from the moment a request's first token is sampled (the
program's ``req.first_token`` instant, after the sampling's wait) to the
moment ``LLMService.poll`` hands it back (``req.delivered``, the same
request id), over the requests whose first token was sampled inside the
profiled stretch: the part of TTFT that the rest of the step holds."""

from perfbench.metrics import _program as P


def read(run):
    prog = P.program(run)
    if prog is None:
        return None
    lo, hi = run.trace.lo, run.trace.hi
    delivered = {}
    for name, rid, t in sorted(prog.instants, key=lambda x: x[2]):
        if name == "delivered":
            delivered.setdefault(rid, []).append(t)
    holds = []
    for name, rid, t in prog.instants:
        if name == "first_token" and lo <= t <= hi:
            later = [d for d in delivered.get(rid, ()) if d >= t]
            if later:
                holds.append(later[0] - t)
    if not holds:
        return None
    return 1e3 * sum(holds) / len(holds)
