"""Mean wall ms of a ``poll`` whose iteration decoded and ran no prefill
chunk, on the benchmark's clock around the call, over all such polls of
the window but those of the profiled stretch (sampling copies the tokens
to the host every iteration, so each poll ends synchronised)."""


def read(run):
    ts = [p.t1 - p.t0 for p in run.window_polls()
          if p.decodes and not p.chunks]
    if not ts:
        return None
    return 1e3 * sum(ts) / len(ts)
