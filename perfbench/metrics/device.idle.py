"""Share of the profiled stretch, in percent, in which no operation ran on
the device: 1 - (union of the device's operation intervals) / (the
stretch's wall time). The profiler's own host cost lengthens the stretch,
so this reads higher than in an untraced run."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
