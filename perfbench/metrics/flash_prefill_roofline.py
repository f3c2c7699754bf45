"""Share of its roofline, in percent, that prefill attention reaches: the
sum over the profiled stretch's calls of the engine module's
``prefill_attention_paged`` of each chunk's bound (``_yardstick.
prefill_attention_work``: ``4 x Dh x H`` per valid causal pair, q and out
and the context's K/V once), over the device time of the kernels inside
the benchmark's span around those calls."""

from perfbench.metrics import _yardstick as Y


def read(run):
    tr, calls = run.trace, (run.calls or {}).get("prefill_attention_paged")
    if tr is None or not calls:
        return None
    secs, n = tr.span_device_s("pb.prefill_attention_paged")
    if not n:
        return None
    bound = sum(Y.bound_s(*Y.prefill_attention_work(
        c["start"], c["length"], c["heads"], c["kv_heads"], c["head_dim"],
        c["window"], c["elem"])) for c in calls)
    return Y.roofline_pct(bound, secs)
