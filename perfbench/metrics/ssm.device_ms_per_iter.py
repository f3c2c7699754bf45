"""Device ms per engine iteration of the operations launched inside the
program's ``ssm.mixer`` spans (each SSM layer's mixer, ``in_proj`` to
``out_proj``, in prefill chunks and decode steps), over the profiled
stretch. A program without those spans gives nothing."""

from perfbench.metrics import _engine_ops as E


def read(run):
    tr = run.trace
    if tr is None or not tr.iterations:
        return None
    placed = E.spans(run, "ssm.mixer")
    if placed is None:
        return None
    secs = sum(E.device_s(tr, placed))
    if secs <= 0:
        return None
    return 1e3 * secs / tr.iterations
