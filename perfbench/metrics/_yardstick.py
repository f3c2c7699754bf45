"""The benchmark's fixed arithmetic: peaks, percentiles, the window's
end-to-end metrics, the kernels' roofline bounds and the model FLOP count.

Every function here works on plain numbers that the harness recorded, and
none imports the program, so later changes to the program cannot move the
yardstick. A model's widths come from its configuration file under
``perfbench/configs/`` (keys as the public ``config.json`` names them).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# a request with no first token sorts above every served one
UNSERVED = math.inf


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest rank: ``sorted(values)[min(n - 1, int(q / 100 * n))]``;
    ``inf`` for no values (a percentile over nothing meets no limit)."""
    n = len(values)
    if n == 0:
        return math.inf
    q = min(100.0, max(0.0, q))
    return sorted(values)[min(n - 1, int(q / 100.0 * n))]


# -- the window's end-to-end metrics ------------------------------------------

def tokens_per_s(deliveries: Iterable[float], t_open: float,
                 t_close: float) -> float:
    """Output tokens delivered to the clients in ``[t_open, t_close)``,
    over the window's seconds. ``deliveries``: one time per token."""
    n = sum(1 for t in deliveries if t_open <= t < t_close)
    return n / (t_close - t_open)


def ttfts(requests, t_open: float, t_close: float) -> List[float]:
    """Time to first token of every request sent in ``[t_open, t_close)``:
    first delivery minus send. A request that failed, or that had no
    first token, counts as :data:`UNSERVED`. ``requests``: objects with
    ``sent``, ``tokens`` (delivery times) and ``failed``."""
    out = []
    for r in requests:
        if not t_open <= r.sent < t_close:
            continue
        out.append(UNSERVED if r.failed or not r.tokens
                   else r.tokens[0] - r.sent)
    return out


def itls(requests, t_open: float, t_close: float) -> List[float]:
    """Every gap between consecutive delivered tokens of one request, both
    delivered in ``[t_open, t_close)``, pooled over the requests."""
    out = []
    for r in requests:
        ts = [t for t in r.tokens if t_open <= t < t_close]
        out.extend(b - a for a, b in zip(ts, ts[1:]))
    return out


def end_to_end(requests, t_open: float, t_close: float) -> Dict[str, float]:
    """The three end-to-end metrics of a window: ``tokens_per_s``,
    ``ttft_p90_ms`` and ``itl_p95_ms``."""
    return {
        "tokens_per_s": tokens_per_s(
            (t for r in requests for t in r.tokens), t_open, t_close),
        "ttft_p90_ms": 1e3 * percentile(ttfts(requests, t_open, t_close), 90),
        "itl_p95_ms": 1e3 * percentile(itls(requests, t_open, t_close), 95),
    }


# -- kernel rooflines -----------------------------------------------------------

def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over HBM bandwidth."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def decode_attention_work(ctx_lens: Iterable[int], heads: int,
                          kv_heads: int, head_dim: int,
                          window: Optional[int] = None,
                          elem_bytes: int = 2) -> Tuple[float, float]:
    """(ops, bytes) of one decode attention call: per active sequence
    (context > 0) its K and V, ``min(ctx, window) x Hkv x Dh x 2``
    elements, read once, q and out once, and ``4 x Dh x H`` operations per
    key. Inactive slots count nothing."""
    ops = nbytes = 0.0
    for c in ctx_lens:
        if c <= 0:
            continue
        keys = min(c, window) if window else c
        ops += 4.0 * head_dim * heads * keys
        nbytes += elem_bytes * (keys * kv_heads * head_dim * 2
                                + 2 * heads * head_dim)
    return ops, nbytes


def causal_pairs(start: int, length: int,
                 window: Optional[int] = None) -> int:
    """(query, key) pairs a chunk of queries at positions ``[start, start +
    length)`` attends causally over keys ``[0, position]`` (the last
    ``window`` of them with a window)."""
    if window is None:
        return length * start + length * (length + 1) // 2
    return sum(min(p + 1, window) for p in range(start, start + length))


def prefill_attention_work(start: int, length: int, heads: int,
                           kv_heads: int, head_dim: int,
                           window: Optional[int] = None,
                           elem_bytes: int = 2) -> Tuple[float, float]:
    """(ops, bytes) of one prefill chunk's attention: ``4 x Dh x H`` per
    valid causal pair; q and out once, and the K/V of the context up to
    the chunk's end once (the last ``window`` keys of it with a window)."""
    end = start + length
    keys = min(end, window + length - 1) if window else end
    ops = 4.0 * head_dim * heads * causal_pairs(start, length, window)
    nbytes = elem_bytes * (2 * length * heads * head_dim
                           + 2 * keys * kv_heads * head_dim)
    return ops, nbytes


def roofline_pct(bounds_s: float, device_s: float) -> Optional[float]:
    """Share of the bound in percent, or None where no time was read."""
    if device_s <= 0 or bounds_s <= 0:
        return None
    return 100.0 * bounds_s / device_s


# -- model FLOPs ---------------------------------------------------------------

def _is_mla(conf) -> bool:
    return bool(conf.get("kv_lora_rank"))


def layer_flops_per_token(conf, layer: int) -> float:
    """2 x the parameters one token multiplies in layer ``layer`` (its
    projections and MLP; a MoE layer: the router, the experts per token and
    the shared experts, not every expert). Attention over the context is
    counted apart (:func:`attention_flops`)."""
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    if _is_mla(conf):
        r, qr = conf["kv_lora_rank"], conf.get("q_lora_rank") or 0
        dn, dr = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
        dv = conf["v_head_dim"]
        q = d * qr + qr * h * (dn + dr) if qr else d * h * (dn + dr)
        attn = q + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    else:
        hkv = conf["num_key_value_heads"]
        dh = conf["head_dim"]
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
    gated = conf.get("gated_mlp", True)
    mats = 3 if gated else 2
    n_routed = conf.get("n_routed_experts") or 0
    if n_routed and layer >= conf.get("first_k_dense_replace", 0):
        ff = conf["moe_intermediate_size"]
        experts = conf["num_experts_per_tok"] + conf.get("n_shared_experts", 0)
        mlp = d * n_routed + experts * 3 * d * ff
    else:
        ff = conf.get("intermediate_size") or conf["ffn_dim"]
        mlp = mats * d * ff
    return 2.0 * (attn + mlp)


def attention_flops(conf, context_sum: int) -> float:
    """Scores and values of every layer over ``context_sum`` (query, key)
    pairs: ``2 x H x (dk + dv)`` per pair and layer."""
    h = conf["num_attention_heads"]
    if _is_mla(conf):
        dk = conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"]
        dv = conf["v_head_dim"]
    else:
        dk = dv = conf["head_dim"]
    return 2.0 * h * (dk + dv) * context_sum * conf["num_hidden_layers"]


def model_flops(conf, tokens: int, context_sum: int, sampled: int) -> float:
    """FLOPs the model needs for ``tokens`` processed tokens whose causal
    contexts sum to ``context_sum`` pairs, ``sampled`` of them unembedded.
    Padding, capacity slack and rows that are not in use count nothing."""
    per_token = sum(layer_flops_per_token(conf, i)
                    for i in range(conf["num_hidden_layers"]))
    unembed = 2.0 * conf["hidden_size"] * conf["vocab_size"]
    return per_token * tokens + attention_flops(conf, context_sum) \
        + unembed * sampled


def mfu_pct(flops: float, seconds: float) -> Optional[float]:
    if seconds <= 0:
        return None
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)


# -- device trace --------------------------------------------------------------

def union_s(intervals: Iterable[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps
