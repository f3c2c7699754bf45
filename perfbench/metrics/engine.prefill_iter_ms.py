"""Mean wall ms of a ``poll`` whose iteration ran at least one prefill
chunk, on the benchmark's clock, over the window's polls but those of the
profiled stretch."""


def read(run):
    ts = [p.t1 - p.t0 for p in run.window_polls() if p.chunks]
    if not ts:
        return None
    return 1e3 * sum(ts) / len(ts)
