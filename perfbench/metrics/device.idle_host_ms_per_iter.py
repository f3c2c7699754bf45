"""Device idle ms per engine iteration while the host does anything but
launch the layers or wait for the sampled tokens: the parts of the
profiled stretch's idle gaps inside every other program span (scheduling,
inputs, sampling launches, emitting, delivery) and outside any, over the
stretch's iterations. With ``device.idle_launch_ms_per_iter`` and the idle
inside ``sample.wait`` it sums to ``device.idle`` of the stretch."""

from perfbench.metrics import _program as P


def read(run):
    split = P.idle_split(run)
    if split is None:
        return None
    return 1e3 * split[1] / run.trace.iterations
