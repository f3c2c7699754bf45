"""The yardstick's arithmetic against hand counts at small shapes, and the
reduction of a device trace on made-up events."""

import math
import types

import pytest

from perfbench import tiny
from perfbench.metrics import _yardstick as Y
from perfbench.profile import Trace


def test_percentile_nearest_rank():
    vals = list(range(1, 11))  # 1..10
    assert Y.percentile(vals, 90) == 10
    assert Y.percentile(vals, 50) == 6
    assert Y.percentile(vals, 0) == 1
    assert Y.percentile([3.0], 95) == 3.0
    assert Y.percentile([], 90) == math.inf
    assert Y.percentile([5, math.inf, 1], 90) == math.inf


def test_decode_attention_work_by_hand():
    h, hkv, dh = 4, 2, 8
    ops, nbytes = Y.decode_attention_work([10, 300], h, hkv, dh)
    assert ops == 4 * dh * h * (10 + 300)
    assert nbytes == 2 * ((10 + 300) * hkv * dh * 2 + 2 * 2 * h * dh)
    # inactive slots count nothing
    assert Y.decode_attention_work([0, 10, 0, 300, 0], h, hkv, dh) == \
        (ops, nbytes)
    # a window caps the keys
    ops_w, bytes_w = Y.decode_attention_work([10, 300], h, hkv, dh, window=64)
    assert ops_w == 4 * dh * h * (10 + 64)
    assert bytes_w == 2 * ((10 + 64) * hkv * dh * 2 + 2 * 2 * h * dh)


def test_prefill_attention_work_by_hand():
    # queries at 3..6 see 4, 5, 6 and 7 keys
    assert Y.causal_pairs(3, 4) == 22
    assert Y.causal_pairs(0, 1) == 1
    assert Y.causal_pairs(3, 4, window=2) == 8
    assert Y.causal_pairs(0, 5, window=2) == 1 + 2 * 4
    h, hkv, dh = 4, 1, 16
    ops, nbytes = Y.prefill_attention_work(3, 4, h, hkv, dh)
    assert ops == 4 * dh * h * 22
    assert nbytes == 2 * (2 * 4 * h * dh + 2 * 7 * hkv * dh)
    # the padded length never enters: the count is the chunk's own
    assert Y.prefill_attention_work(3, 4, h, hkv, dh) != \
        Y.prefill_attention_work(3, 8, h, hkv, dh)
    _, nb = Y.prefill_attention_work(100, 4, h, hkv, dh, window=8)
    assert nb == 2 * (2 * 4 * h * dh + 2 * 11 * hkv * dh)


def test_roofline_is_100_when_time_equals_bound():
    ops, nbytes = Y.decode_attention_work([500, 70], 40, 40, 128)
    b = Y.bound_s(ops, nbytes)
    assert b == nbytes / Y.HBM_BYTES_PER_S  # decode is bound by bytes
    assert Y.roofline_pct(b, b) == pytest.approx(100.0)
    assert Y.roofline_pct(b, 2 * b) == pytest.approx(50.0)
    assert Y.roofline_pct(b, 0.0) is None
    ops = 4 * 128 * 40 * Y.causal_pairs(0, 2048)
    assert Y.bound_s(ops, 1.0) == ops / Y.PEAK_BF16_FLOPS


def test_model_flops_dense_by_hand():
    c = tiny.DENSE
    d, h, hkv, dh, ff = 64, 4, 2, 16, 128
    layer = 2 * (d * h * dh + 2 * d * hkv * dh + h * dh * d + 2 * d * ff)
    assert Y.layer_flops_per_token(c, 0) == layer
    attn = 2 * h * (dh + dh) * 10 * 2  # 10 pairs, 2 layers
    unembed = 2 * d * 512
    assert Y.model_flops(c, 5, 10, 3) == 2 * layer * 5 + attn + 3 * unembed
    # rows with no context (inactive slots) and padding add nothing
    assert Y.model_flops(c, 0, 0, 0) == 0


def test_model_flops_mla_moe_by_hand():
    c = tiny.MLA
    d, h, r, qr, dn, dr, dv = 64, 4, 32, 48, 16, 8, 16
    attn = d * qr + qr * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) \
        + h * dv * d
    dense = 2 * (attn + 3 * d * 128)
    moe = 2 * (attn + d * 8 + (2 + 1) * 3 * d * 32)  # top-2 + 1 shared
    assert Y.layer_flops_per_token(c, 0) == dense
    assert Y.layer_flops_per_token(c, 1) == moe
    assert Y.attention_flops(c, 7) == 2 * h * (dn + dr + dv) * 7 * 3
    assert Y.mfu_pct(Y.PEAK_BF16_FLOPS, 1.0) == pytest.approx(100.0)


def test_union_and_gaps():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (10.0, 11.0)]
    assert Y.union_s(ivs, 0.0, 5.0) == pytest.approx(3.0)
    assert Y.idle_gaps(ivs, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert Y.union_s([], 0.0, 1.0) == 0.0


def _client(sent, tokens, failed=False):
    return types.SimpleNamespace(sent=sent, tokens=tokens, failed=failed)


def _steady(stall=None):
    """Four requests in flight, one token each every 0.1 s on [0, 10);
    with ``stall=(a, b)`` nothing is delivered in [a, b)."""
    clients = []
    for i in range(40):
        sent = 0.25 * i
        ts = [sent + 0.05 + 0.1 * k for k in range(20)]
        if stall:
            a, b = stall
            ts = [t if t < a else t + (b - a) for t in ts]
        clients.append(_client(sent, ts))
    return clients


def test_a_stall_moves_all_three_end_to_end_metrics():
    base = Y.end_to_end(_steady(), 0.0, 10.0)
    stalled = Y.end_to_end(_steady(stall=(4.0, 6.0)), 0.0, 10.0)
    assert stalled["tokens_per_s"] < base["tokens_per_s"]
    assert stalled["ttft_p90_ms"] > base["ttft_p90_ms"]
    assert stalled["itl_p95_ms"] > base["itl_p95_ms"]


def test_failed_and_unserved_requests_sort_above_every_served_one():
    cs = [_client(1.0, [1.2]), _client(2.0, [], failed=True),
          _client(3.0, [])]
    assert sorted(Y.ttfts(cs, 0.0, 10.0)) == \
        [pytest.approx(0.2), math.inf, math.inf]
    assert Y.ttfts(cs, 1.5, 10.0) == [math.inf, math.inf]


def test_trace_reduction_on_made_up_events():
    spans = [("pb.window", 0.0, 10.0),
             ("pb.decode", 1.0, 5.0),
             ("pb.paged_attention", 2.0, 3.0),
             ("pb.sample", 6.0, 7.0)]
    ops = [("split_kernel", 2.5, 3.5, 2.1),      # launched in attention
           ("merge_kernel", 3.4, 3.6, 2.9),      # overlaps the split
           ("gemm", 4.0, 4.5, 4.0),              # launched in decode
           ("Memcpy DtoH", 6.5, 6.6, 6.2),       # in sample: not a launch
           ("unlinked", 8.0, 8.5, None)]
    tr = Trace(ops, spans, 0.0, 10.0, iterations=2)
    assert tr.window_s == 10.0
    assert tr.busy_s == pytest.approx(1.1 + 0.5 + 0.1 + 0.5)
    assert tr.idle_pct() == pytest.approx(100 * (1 - 2.2 / 10))
    assert tr.launches() == 4
    t, n = tr.span_device_s("pb.paged_attention")
    assert (t, n) == (pytest.approx(1.1), 1)  # the union, not the sum
    t, n = tr.span_device_s("pb.decode")
    assert t == pytest.approx(1.6)
    assert tr.span_device_s("pb.sample") == (pytest.approx(0.1), 1)
    assert tr.span_device_s("pb.moe_forward") == (0.0, 0)
    gaps = dict(tr.gaps_by_span())
    # idle from 0 to 2.5 began with no span open; 3.6-4.0 inside decode;
    # 4.5-6.5 inside decode; 6.6-8.0 inside sample; 8.5-10 in none
    assert gaps["no span"] == pytest.approx(2.5 + 1.5)
    assert gaps["decode"] == pytest.approx(0.4 + 2.0)
    assert gaps["sample"] == pytest.approx(1.4)
    top = dict(tr.top_ops())
    assert top["span:paged_attention"] == pytest.approx(1.1)
    assert top["kernel:split_kernel"] == pytest.approx(1.0)
