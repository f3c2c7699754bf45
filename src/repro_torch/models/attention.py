"""GQA attention (MHA / MQA / sliding window), one for one with the GQA
part of ``repro.models.attention``.

``blockwise_attention`` is the prefill and full-sequence path. It rounds
q, k, v and the softmax probabilities to bfloat16 and accumulates in
float32, even under a float32 config (``attention.py:119-120,159-161`` of
the reference): float32 token identity with the reference depends on it.
Decode attention over the paged cache stays in float32
(``repro_torch.kernels.paged_attention``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import apply_rope, dense, dense_init, mlp, \
    rms_norm

# queries per block of the score matrix: bounds live memory at
# (B, Q_BLOCK, H, Skv) float32 without changing any query's result
Q_BLOCK = 512


def gqa_init(cfg, gen, dtype, device, *, lead=()):
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(lead=lead, bias=cfg.use_bias)
    return {
        "wq": dense_init(gen, d, h * dh, dtype, device, **kw),
        "wk": dense_init(gen, d, hkv * dh, dtype, device, **kw),
        "wv": dense_init(gen, d, hkv * dh, dtype, device, **kw),
        "wo": dense_init(gen, h * dh, d, dtype, device, **kw),
    }


def _bf16(x):
    """Round to bfloat16 and continue in float32 (the reference's bf16
    operands with ``preferred_element_type=float32``)."""
    return x.to(torch.bfloat16).float()


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None):
    """q: (B,S,H,Dh); k,v: (B,Skv,Hkv,Dh). GQA broadcast, float32 softmax.

    ``q_offset``: absolute position of q[0] relative to k[0]. Valid keys
    for a query at ``p`` are ``k <= p`` (causal) and ``k > p - window``.
    """
    b, s, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = (1.0 / math.sqrt(dh)) if scale is None else scale
    kg = _bf16(k)
    vg = _bf16(v)
    kv_pos = torch.arange(skv, device=q.device)
    outs = []
    for c0 in range(0, s, Q_BLOCK):
        qc = q[:, c0:c0 + Q_BLOCK]
        c = qc.shape[1]
        qpos = q_offset + c0 + torch.arange(c, device=q.device)
        mask = torch.ones(c, skv, dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kv_pos[None, :]
        if window is not None:
            mask &= kv_pos[None, :] > qpos[:, None] - window
        qc = _bf16(qc).reshape(b, c, hkv, g, dh)
        scores = torch.einsum("bchgd,bshd->bchgs", qc, kg) * scale
        scores = scores.masked_fill(~mask[None, :, None, None, :],
                                    float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bchgs,bshd->bchgd", _bf16(probs), vg)
        outs.append(out.reshape(b, c, h, dv).to(q.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def gqa_layer(cfg, p, x, positions, attend, mlp_fn=None):
    """One full GQA transformer layer, parameterised by the attention
    callable: the layer body shared by ``Model.forward`` and the engine's
    paged prefill and decode.

    ``x``: (B, S, D); ``positions``: (S,) or (B, S) absolute positions.
    ``attend(q, k, v) -> ctx`` receives roped q (B, S, H, Dh) and roped k /
    raw v (B, S, Hkv, Dh) and returns the context (B, S, H, Dv). Pre-norm,
    residual attention, pre-norm residual MLP. ``mlp_fn(p_mlp, h) -> out``
    overrides the dense MLP (MoE segments pass their expert dispatch).
    """
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hn = rms_norm(p["ln1"], x, cfg.norm_eps)
    q = dense(p["attn"]["wq"], hn).reshape(b, s, h, dh)
    k = dense(p["attn"]["wk"], hn).reshape(b, s, hkv, dh)
    v = dense(p["attn"]["wv"], hn).reshape(b, s, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ctx = attend(q, k, v)
    y = x + dense(p["attn"]["wo"], ctx.reshape(b, s, -1))
    h2 = rms_norm(p["ln2"], y, cfg.norm_eps)
    y = y + (mlp(p["mlp"], h2) if mlp_fn is None else mlp_fn(p["mlp"], h2))
    return y


def gqa_forward(cfg, p, x, positions, *, window=None,
                return_kv: bool = False):
    """Full-sequence causal GQA self-attention block (no norm, no
    residual). Returns the output, and with ``return_kv`` also the roped
    (k, v)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = apply_rope(dense(p["wq"], x).reshape(b, s, h, dh), positions,
                   cfg.rope_theta)
    k = apply_rope(dense(p["wk"], x).reshape(b, s, hkv, dh), positions,
                   cfg.rope_theta)
    v = dense(p["wv"], x).reshape(b, s, hkv, dh)
    out = blockwise_attention(q, k, v, causal=True, window=window)
    y = dense(p["wo"], out.reshape(b, s, h * dh))
    if return_kv:
        return y, (k, v)
    return y
