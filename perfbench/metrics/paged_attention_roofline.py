"""Share of its roofline, in percent, that decode attention reaches: the
sum over the profiled stretch's calls of the engine module's
``paged_attention`` of each call's bound (``_yardstick.
decode_attention_work`` from the call's own arguments: every active
sequence's K and V read once, q and out once; inactive slots count
nothing), over the device time of the kernels inside the benchmark's span
around those calls."""

from perfbench.metrics import _yardstick as Y


def read(run):
    tr, calls = run.trace, (run.calls or {}).get("paged_attention")
    if tr is None or not calls:
        return None
    secs, n = tr.span_device_s("pb.paged_attention")
    if not n:
        return None
    lens_of, bound = {}, 0.0
    for c in calls:
        key = id(c["lens"])
        if key not in lens_of:
            lens_of[key] = c["lens"].cpu().tolist()
        ops, nbytes = Y.decode_attention_work(
            lens_of[key], c["heads"], c["kv_heads"], c["head_dim"],
            c["window"], c["elem"])
        bound += Y.bound_s(ops, nbytes)
    return Y.roofline_pct(bound, secs)
