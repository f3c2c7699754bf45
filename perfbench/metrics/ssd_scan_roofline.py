"""Share of its roofline, in percent, that the SSD scan reaches: the sum
over the profiled stretch's scan calls (the program's ``ssm.scan`` spans,
whose arguments give each call's tokens, heads, widths, chunk and whether
it carried a state in) of each call's bound (``_ssm_work.ssd_scan_work``;
max of operations / 989e12 and bytes / 3.35e12), over the device time of
the operations launched inside those spans. A program without those spans
gives nothing."""

from perfbench.metrics import _engine_ops as E
from perfbench.metrics import _ssm_work as W
from perfbench.metrics import _yardstick as Y


def read(run):
    tr = run.trace
    if tr is None:
        return None
    placed = E.spans(run, "ssm.scan")
    if placed is None:
        return None
    secs = sum(E.device_s(tr, placed))
    elem = E.elem_bytes(run.conf)
    bound = sum(Y.bound_s(*W.ssd_scan_work(
        1, a["tokens"], a["heads"], a["head_dim"], a["state"], a["groups"],
        a["chunk"], bool(a["carried"]), elem)) for _, _, a in placed)
    return Y.roofline_pct(bound, secs)
