"""Device idle ms per engine iteration while the host launches the model's
layers: the parts of the profiled stretch's idle gaps that fall inside the
program's ``decode.layers`` and ``chunk.layers`` spans (innermost span at
each moment, split by overlap), over the stretch's iterations."""

from perfbench.metrics import _program as P


def read(run):
    split = P.idle_split(run)
    if split is None:
        return None
    return 1e3 * split[0] / run.trace.iterations
