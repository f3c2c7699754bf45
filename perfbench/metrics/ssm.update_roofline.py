"""Share of its memory roofline, in percent, that a decode step's SSM
update reaches: over the profiled stretch's ``ssm.update`` spans (each SSM
layer's conv window, state update and readout in a decode step; their
``active`` argument is the rows that step), the bytes each has to move
(``_ssm_work.ssm_update_bytes``: every stepping row's float32 state and
conv window read and written once, widths from the configuration) at 3.35
TB/s, over the device time of the operations launched inside those spans.
A program without those spans gives nothing."""

from perfbench.metrics import _engine_ops as E
from perfbench.metrics import _ssm_work as W
from perfbench.metrics import _yardstick as Y


def read(run):
    tr, conf = run.trace, run.conf
    if tr is None:
        return None
    placed = E.spans(run, "ssm.update")
    if placed is None:
        return None
    secs = sum(E.device_s(tr, placed))
    channels = conf["mamba_expand"] * conf["hidden_size"] \
        + 2 * conf["mamba_n_groups"] * conf["mamba_d_state"]
    nbytes = sum(W.ssm_update_bytes(
        a["active"], conf["mamba_n_heads"], conf["mamba_d_head"],
        conf["mamba_d_state"], conf["mamba_d_conv"], channels,
        E.elem_bytes(conf)) for _, _, a in placed)
    return Y.roofline_pct(Y.bound_s(0.0, nbytes), secs)
