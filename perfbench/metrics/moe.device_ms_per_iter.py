"""Device ms per engine iteration of the kernels launched inside the
benchmark's span around the engine module's ``moe_forward``, over the
profiled stretch."""


def read(run):
    tr = run.trace
    if tr is None or not tr.iterations:
        return None
    secs, calls = tr.span_device_s("pb.moe_forward")
    if not calls or secs <= 0:
        return None
    return 1e3 * secs / tr.iterations
