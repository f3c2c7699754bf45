"""CUDA kernel launches (the device trace's kernels, no copies or fills)
in the profiled stretch per engine iteration in it."""


def read(run):
    tr = run.trace
    if tr is None or not tr.iterations:
        return None
    n = tr.launches()
    return n / tr.iterations if n else None
