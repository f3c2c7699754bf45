"""Share of the engine's step time, in percent, that the host spends
waiting for the device's sampled tokens: the program's ``sample.wait``
spans (the copies of the tokens to the host, a step's one stream sync)
over its ``iteration`` spans, inside the profiled stretch. A host that
waits on the card is not starving it, so higher is better; a host-bound
cell reads near 0."""

from perfbench.metrics import _program as P


def read(run):
    prog = P.program(run)
    if prog is None:
        return None
    lo, hi = run.trace.lo, run.trace.hi
    steps = P.span_s(prog, "iteration", lo, hi)
    if steps <= 0:
        return None
    return 100.0 * P.span_s(prog, P.WAIT, lo, hi) / steps
