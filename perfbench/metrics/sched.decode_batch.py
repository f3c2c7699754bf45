"""Mean running decode sequences per iteration: the rows with a context in
each decode step of the window, over the iterations that decoded (the
engine's decode calls as the benchmark's span recorded them; the polls of
the profiled stretch are left out)."""


def read(run):
    rows = [int((w[1] > 0).sum()) for p in run.window_polls()
            for w in p.work if w[0] == "decode"]
    if not rows:
        return None
    return sum(rows) / len(rows)
