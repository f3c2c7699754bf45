"""Attention variants, one for one with ``repro.models.attention``: GQA
(MHA / MQA / sliding window) and MLA (DeepSeek-V2's multi-head latent
attention).

``blockwise_attention`` is the prefill and full-sequence path. It rounds
q, k, v and the softmax probabilities to bfloat16 and accumulates in
float32, even under a float32 config (``attention.py:119-120,159-161`` of
the reference): float32 token identity with the reference depends on it.
GQA decode attention over the paged cache stays in float32
(``repro_torch.kernels.paged_attention``).

``Model.decode_step`` attends over ring-buffer caches instead
(:class:`KVCache`, :class:`MLACache`): a cache of capacity ``Sc`` keeps
position ``p`` in slot ``p % Sc`` and remembers each slot's absolute
position (-1 while empty), so a sliding-window segment holds only its
window. ``gqa_decode`` and ``mla_decode`` compute that attention as the
reference does, in plain einsums with bfloat16 operands (``attention.py:
311-321, 403-420``): the reference has no kernel there.

MLA caches only the shared latent per token: ``ckv`` (``kv_lora_rank``,
normed) and ``krope`` (``qk_rope_head_dim``, roped). ``mla_forward``
decompresses it to per-head K/V and runs standard attention (the
teacher-forced path); ``mla_layer`` attends over the latent directly, with
W_UK folded into the queries and W_UV into the output (matrix absorption):
the engine's paged prefill and decode. Neither reaches a kernel, in the
reference or here: the reference computes them in XLA.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import NO_POLICY, ShardingPolicy, \
    apply_rope, dense, dense_init, mlp, norm_init, pad_last, rms_norm, \
    split_heads

# queries per block of the score matrix: bounds live memory at
# (B, Q_BLOCK, H, Skv) float32 without changing any query's result
Q_BLOCK = 512


class KVCache(NamedTuple):
    """Ring-buffer KV cache of a GQA segment (``attention.py:38-44``).
    Leaves carry a leading layer axis in a segment of several layers."""

    k: torch.Tensor  # (B, Sc, Hkv, Dh)
    v: torch.Tensor  # (B, Sc, Hkv, Dh)
    pos: torch.Tensor  # (B, Sc) int32 absolute position per slot, -1 = empty


class MLACache(NamedTuple):
    """Ring-buffer latent cache of an MLA segment (``attention.py:47-50``)."""

    ckv: torch.Tensor  # (B, Sc, r) normed latent
    krope: torch.Tensor  # (B, Sc, dr) roped shared rope key
    pos: torch.Tensor  # (B, Sc) int32


def gqa_init(cfg, gen, dtype, device, *, lead=()):
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(lead=lead, bias=cfg.use_bias)
    return {
        "wq": dense_init(gen, d, h * dh, dtype, device, **kw),
        "wk": dense_init(gen, d, hkv * dh, dtype, device, **kw),
        "wv": dense_init(gen, d, hkv * dh, dtype, device, **kw),
        "wo": dense_init(gen, h * dh, d, dtype, device, **kw),
    }


def mla_init(cfg, gen, dtype, device, *, lead=()):
    """``mla_init`` of the reference (``attention.py:68-86``): the latent
    down-projection ``wkv_a`` (d, r + dr), its norm, the up-projection
    ``wkv_b`` (r, H (dn + dv)), ``wo``, and the query path, low-rank
    (``wq_a`` / ``q_norm`` / ``wq_b``) where ``q_lora_rank`` is set, else
    one ``wq``."""
    d, h = cfg.d_model, cfg.num_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    p = {
        "wkv_a": dense_init(gen, d, r + dr, dtype, device, lead=lead),
        "kv_norm": norm_init(r, dtype, device, lead=lead),
        "wkv_b": dense_init(gen, r, h * (dn + dv), dtype, device, lead=lead),
        "wo": dense_init(gen, h * dv, d, dtype, device, lead=lead),
    }
    if qr:
        p["wq_a"] = dense_init(gen, d, qr, dtype, device, lead=lead)
        p["q_norm"] = norm_init(qr, dtype, device, lead=lead)
        p["wq_b"] = dense_init(gen, qr, h * (dn + dr), dtype, device,
                               lead=lead)
    else:
        p["wq"] = dense_init(gen, d, h * (dn + dr), dtype, device, lead=lead)
    return p


def _bf16(x):
    """Round to bfloat16 and continue in float32 (the reference's bf16
    operands with ``preferred_element_type=float32``)."""
    return x.to(torch.bfloat16).float()


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None,
                        policy: ShardingPolicy = NO_POLICY):
    """q: (B,S,H,Dh); k,v: (B,Skv,Hkv,Dh). GQA broadcast, float32 softmax.

    ``q_offset``: absolute position of q[0] relative to k[0]. Valid keys
    for a query at ``p`` are ``k <= p`` (causal) and ``k > p - window``.

    Where the policy prefers flat heads (H divides the ``model`` axis and
    Hkv does not: mistral-large's 96 / 8 heads on 16), K/V are broadcast
    to H heads and the scores keep a flat, shardable head axis
    (``attention.py:128-148`` of the reference): the same products as the
    grouped form. A mesh policy runs the attention on each rank's heads
    and sequences where the layouts allow (``local_attention``).
    """
    if policy is not NO_POLICY:
        out = policy.local_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
        if out is not None:
            return out
    b, s, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = (1.0 / math.sqrt(dh)) if scale is None else scale
    kg = _bf16(k)
    vg = _bf16(v)
    kv_pos = torch.arange(skv, device=q.device)
    flat = policy.prefers_flat_heads(h, hkv)
    if flat:
        kg = policy.act(kg[:, :, :, None, :].expand(b, skv, hkv, g, dh)
                        .reshape(b, skv, h, dh), "kvrep_bshd")
        vg = policy.act(vg[:, :, :, None, :].expand(b, skv, hkv, g, dv)
                        .reshape(b, skv, h, dv), "kvrep_bshd")
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
        if flat:
            scores = policy.act(torch.einsum("bchd,bshd->bchs", _bf16(qc),
                                             kg) * scale, "scores_bchs")
            scores = scores.masked_fill(~mask[None, :, None, :],
                                        float("-inf"))
            probs = policy.act(torch.softmax(scores, dim=-1), "scores_bchs")
            out = torch.einsum("bchs,bshd->bchd", _bf16(probs), vg)
            outs.append(out.to(q.dtype))
            continue
        qc = _bf16(qc).reshape(b, c, hkv, g, dh)
        scores = policy.act(torch.einsum("bchgd,bshd->bchgs", qc, kg)
                            * scale, "scores_bchgs")
        scores = scores.masked_fill(~mask[None, :, None, None, :],
                                    float("-inf"))
        probs = policy.act(torch.softmax(scores, dim=-1), "scores_bchgs")
        out = torch.einsum("bchgs,bshd->bchgd", _bf16(probs), vg)
        outs.append(out.reshape(b, c, h, dv).to(q.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def gqa_layer(cfg, p, x, positions, attend, mlp_fn=None):
    """One full GQA transformer layer, parameterised by the attention
    callable: the layer body of the engine's paged prefill and decode
    (``Model`` runs the same ops through ``_layer_forward``).

    ``x``: (B, S, D); ``positions``: (S,) or (B, S) absolute positions.
    ``attend(q, k, v) -> ctx`` receives roped q (B, S, H, Dh) and roped k /
    raw v (B, S, Hkv, Dh) and returns the context (B, S, H, Dv). Pre-norm,
    residual attention, pre-norm residual MLP. ``mlp_fn(p_mlp, h) -> out``
    overrides the dense MLP (MoE segments pass their expert dispatch).
    """
    return gqa_layer_out(cfg, p, x, attend(*gqa_layer_qkv(cfg, p, x,
                                                          positions)),
                         mlp_fn)


def gqa_layer_qkv(cfg, p, x, positions):
    """:func:`gqa_layer` up to its attention: the pre-norm and the
    projections, q and k roped. Returns (q, k, v)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hn = rms_norm(p["ln1"], x, cfg.norm_eps)
    q = dense(p["attn"]["wq"], hn).reshape(b, s, h, dh)
    k = dense(p["attn"]["wk"], hn).reshape(b, s, hkv, dh)
    v = dense(p["attn"]["wv"], hn).reshape(b, s, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_layer_out(cfg, p, x, ctx, mlp_fn=None):
    """:func:`gqa_layer` after its attention: the output projection of the
    context ``ctx`` (B, S, H, Dv), the residual, and the residual MLP."""
    b, s, _ = x.shape
    y = x + dense(p["attn"]["wo"], ctx.reshape(b, s, -1))
    h2 = rms_norm(p["ln2"], y, cfg.norm_eps)
    y = y + (mlp(p["mlp"], h2) if mlp_fn is None else mlp_fn(p["mlp"], h2))
    return y


def gqa_forward(cfg, p, x, positions, *, window=None, causal: bool = True,
                kv_override=None, return_kv: bool = False, attend=None,
                policy: ShardingPolicy = NO_POLICY):
    """Full-sequence GQA attention block (no norm, no residual). Returns
    the output, and with ``return_kv`` also the (k, v) it attended over.
    ``kv_override=(k, v)`` is cross-attention (``attention.py:219-246``):
    K/V (B, Skv, Hkv, Dh) come from the encoder (:func:`encode_kv`) and
    neither q nor k is roped. ``attend(q, k, v) -> ctx`` replaces
    ``blockwise_attention(causal=causal, window=window)``
    (``Model.prefill`` passes the kernel's dispatch). ``policy`` hooks
    sit where the reference's do (``attention.py:207-242``)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(dense(p["wq"], x), h, dh)
    if kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(split_heads(dense(p["wk"], x), hkv, dh), positions,
                       cfg.rope_theta)
        v = split_heads(dense(p["wv"], x), hkv, dh)
    else:
        k, v = kv_override
    q = policy.act(q, "heads_bshd")
    k = policy.act(k, "kv_bshd")
    v = policy.act(v, "kv_bshd")
    if attend is None:
        out = blockwise_attention(q, k, v, causal=causal, window=window,
                                  policy=policy)
    else:
        out = attend(q, k, v)
    out = policy.act(out, "heads_bshd")
    y = dense(p["wo"], out.reshape(b, s, h * dh), policy, "act_bsd")
    if return_kv:
        return y, (k, v)
    return y


def encode_kv(cfg, p, x):
    """The encoder output x (B, Skv, D) projected to cross-attention K/V,
    each (B, Skv, Hkv, Dh), without rope (``attention.py:249-255``)."""
    b, s, _ = x.shape
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    return split_heads(dense(p["wk"], x), hkv, dh), \
        split_heads(dense(p["wv"], x), hkv, dh)


# ---------------------------------------------------------------------------
# decode: one token against a ring-buffer cache
# ---------------------------------------------------------------------------

def cache_update(cache_pos, pos):
    """The ring slot of absolute position ``pos`` in a cache of capacity
    Sc (``attention.py:262-265``)."""
    return pos % cache_pos.shape[-1]


def _write_slot(buf, slot, new):
    """A copy of ``buf`` (B, Sc, ...) with ``new`` (B, ...) written at each
    row's ``slot``; ``buf`` itself is not changed. A DTensor (a mesh's
    sequence-sharded cache) takes the write elementwise over the slot
    index, which shards; an indexed write into a sharded axis does not."""
    if isinstance(buf, DTensor):
        at = torch.arange(buf.shape[1], device=buf.device) == slot[:, None]
        at = at.reshape(at.shape + (1,) * (buf.dim() - 2))
        return torch.where(at, new.to(buf.dtype)[:, None], buf)
    out = buf.clone()
    out[torch.arange(buf.shape[0], device=buf.device), slot] = \
        new.to(buf.dtype)
    return out


def _decode_mask(cache_pos, pos, window):
    """(B, Sc) validity of each slot for the query at absolute ``pos``."""
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window is not None:
        valid &= cache_pos > (pos[:, None] - window)
    return valid


def gqa_decode(cfg, p, x, cache: KVCache, pos, *, window=None,
               kv_override=None, policy: ShardingPolicy = NO_POLICY):
    """x: (B, 1, D); pos: (B,) absolute position of the new token. Writes
    its K/V into the ring and attends over the valid slots, as the
    reference does (``attention.py:282-324``): bfloat16 q, k, v and
    probabilities, float32 scores and sums. With ``kv_override=(k, v)``
    (cross-attention over the encoder's K/V, (B, Skv, Hkv, Dh)) nothing is
    roped or written and every key is valid; ``cache`` is returned as it
    came (the reference passes None). Returns (y (B, 1, D), the cache).
    Over a sequence-sharded cache (a mesh policy's DistAttention layout)
    the policy's ``decode_attention`` computes the attention: float32
    partials per shard and their merge, no gather of K/V."""
    b = x.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(dense(p["wq"], x), h, dh)
    if kv_override is None:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        knew = apply_rope(split_heads(dense(p["wk"], x), hkv, dh),
                          pos[:, None], cfg.rope_theta)
        vnew = split_heads(dense(p["wv"], x), hkv, dh)
        slot = cache_update(cache.pos, pos)
        cache = KVCache(k=_write_slot(cache.k, slot, knew[:, 0]),
                        v=_write_slot(cache.v, slot, vnew[:, 0]),
                        pos=_write_slot(cache.pos, slot, pos))
        mask = _decode_mask(cache.pos, pos, window)  # (B, Sc)
        k, v = cache.k, cache.v
    else:
        k, v = kv_override
        mask = None  # every encoder position
    k = policy.act(k, "kvcache_bskd")
    v = policy.act(v, "kvcache_bskd")
    out = None if policy is NO_POLICY else policy.decode_attention(
        _bf16(q[:, 0]), k, v, mask, 1.0 / math.sqrt(dh))
    if out is None:
        qg = _bf16(q.reshape(b, hkv, h // hkv, dh))
        scores = torch.einsum("bhgd,bshd->bhgs", qg, _bf16(k)) \
            / math.sqrt(dh)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :],
                                        float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgs,bshd->bhgd", _bf16(probs), _bf16(v))
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return dense(p["wo"], out, policy, "act_bsd"), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_q(cfg, p, x):
    """Queries (B, S, H, dn) without rope and (B, S, H, dr) to rope."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if "wq_a" in p:
        q = dense(p["wq_b"], rms_norm(p["q_norm"], dense(p["wq_a"], x),
                                      cfg.norm_eps))
    else:
        q = dense(p["wq"], x)
    q = split_heads(q, cfg.num_heads, dn + dr)
    return q[..., :dn], q[..., dn:]


def _mla_scale(cfg):
    """The conceptual head dim's scale, ``1/sqrt(dn + dr)``: the absorbed
    form scores in the lifted width r + dr but must scale as the
    decompressed one does."""
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_latent(cfg, p, x, positions):
    """This sequence's latent payload: ``ckv`` (B, S, r) normed and
    ``krope`` (B, S, dr) roped, exactly what the pools store."""
    r = cfg.kv_lora_rank
    kv = dense(p["wkv_a"], x)
    ckv = rms_norm(p["kv_norm"], kv[..., :r], cfg.norm_eps)
    krope = apply_rope(kv[..., r:], positions, cfg.rope_theta, heads=False)
    return ckv, krope


def mla_forward(cfg, p, x, positions, *, return_latent: bool = False,
                policy: ShardingPolicy = NO_POLICY):
    """Full-sequence causal MLA block (no norm, no residual): decompress the
    latent to per-head K/V and run standard attention, scaled by the
    concatenated head dim dn + dr. With ``return_latent`` also the latent
    ``(ckv, krope)``: the seed of the decode cache."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    qn, qr = _mla_q(cfg, p, x)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    ckv, krope = _mla_latent(cfg, p, x, positions)
    kvb = split_heads(dense(p["wkv_b"], ckv), h, dn + dv)
    kn, v = kvb[..., :dn], kvb[..., dn:]
    q = policy.act(torch.cat([qn, qr], dim=-1), "heads_bshd")
    k = torch.cat([kn, krope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    out = blockwise_attention(q, k, v, causal=True, policy=policy)
    y = dense(p["wo"], out.reshape(b, s, h * dv), policy, "act_bsd")
    if return_latent:
        return y, (ckv, krope)
    return y


def mla_decode(cfg, p, x, cache: MLACache, pos, *,
               policy: ShardingPolicy = NO_POLICY):
    """Matrix-absorbed MLA decode over the latent ring
    (``attention.py:380-424``): writes the new token's latent, scores
    ``q_lat . ckv + qr . krope`` over the valid slots, takes the context
    in the latent and lifts it through W_UV; every product on bfloat16
    operands with float32 sums. x: (B, 1, D); pos: (B,). Returns (y, the
    new cache). Over a sequence-sharded latent the policy's
    ``decode_attention`` attends, the latent as one KV head (keys ckv and
    krope, values ckv)."""
    b = x.shape[0]
    h, dv = cfg.num_heads, cfg.v_head_dim
    qn, qr = _mla_q(cfg, p, x)  # (B, 1, H, dn), (B, 1, H, dr)
    qr = apply_rope(qr, pos[:, None], cfg.rope_theta)
    ckv_new, krope_new = _mla_latent(cfg, p, x, pos[:, None])
    slot = cache_update(cache.pos, pos)
    cache = MLACache(ckv=_write_slot(cache.ckv, slot, ckv_new[:, 0]),
                     krope=_write_slot(cache.krope, slot, krope_new[:, 0]),
                     pos=_write_slot(cache.pos, slot, pos))
    mask = _decode_mask(cache.pos, pos, None)  # (B, Sc)
    w_uk, w_uv = mla_absorb(cfg, p)
    ckv = _bf16(policy.act(cache.ckv, "mlacache_bsr"))
    q_lat = torch.einsum("bhd,rhd->bhr", _bf16(qn[:, 0]), _bf16(w_uk))
    krope = _bf16(cache.krope)
    ctx = None if policy is NO_POLICY else policy.decode_attention(
        torch.cat([_bf16(q_lat), _bf16(qr[:, 0])], dim=-1),
        torch.cat([ckv, krope], dim=-1)[:, :, None], ckv[:, :, None], mask,
        _mla_scale(cfg))
    if ctx is None:
        scores = torch.einsum("bhr,bsr->bhs", _bf16(q_lat), ckv)
        scores = scores + torch.einsum("bhd,bsd->bhs", _bf16(qr[:, 0]),
                                       krope)
        scores = (scores * _mla_scale(cfg)).masked_fill(~mask[:, None, :],
                                                        float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhs,bsr->bhr", _bf16(probs), ckv)
    out = torch.einsum("bhr,rhd->bhd", _bf16(ctx), _bf16(w_uv))
    return dense(p["wo"], out.reshape(b, 1, h * dv).to(x.dtype), policy,
                 "act_bsd"), cache


def mla_absorb(cfg, p):
    """``wkv_b`` split into the absorbed matrices ``(w_uk, w_uv)``, shapes
    (r, H, dn) and (r, H, dv): W_UK folds into the queries, W_UV into the
    output projection."""
    r, h = cfg.kv_lora_rank, cfg.num_heads
    dn = cfg.qk_nope_head_dim
    wkv_b = p["wkv_b"]["w"].reshape(r, h, -1)
    return wkv_b[..., :dn], wkv_b[..., dn:]


def mla_effective_ctx(ckv, krope):
    """The latent context as one effective KV head: keys ``concat(ckv,
    krope)``, values ``ckv`` zero-padded to the key width (the context's
    pad columns stay zero; slice it back to ``[..., :r]``).

    ckv: (B, T, r); krope: (B, T, dr) -> k_eff, v_eff: (B, T, 1, r + dr).
    """
    k_eff = torch.cat([ckv, krope], dim=-1)[:, :, None, :]
    v_eff = pad_last(ckv, k_eff.shape[-1])[:, :, None, :]
    return k_eff, v_eff


def mla_effective_kv(q_lat, qr, ckv, krope):
    """Absorbed MLA as single-KV-head attention: queries ``concat(q_lat,
    qr)`` (scores decompose as q_lat . ckv + qr . krope), K/V from
    :func:`mla_effective_ctx`. Callers scale by ``_mla_scale(cfg)``.

    q_lat: (B, S, H, r); qr: (B, S, H, dr); ckv: (B, T, r); krope: (B, T,
    dr).
    """
    q_eff = torch.cat([q_lat, qr], dim=-1)
    k_eff, v_eff = mla_effective_ctx(ckv, krope)
    return q_eff, k_eff, v_eff


def mla_attention(cfg, p, hn, positions, attend_latent):
    """The absorbed MLA block of :func:`mla_layer` on normed input ``hn``
    (no residual): output (B, S, D)."""
    b, s, _ = hn.shape
    h, dv = cfg.num_heads, cfg.v_head_dim
    qn, qr = _mla_q(cfg, p, hn)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    ckv_new, krope_new = _mla_latent(cfg, p, hn, positions)
    w_uk, w_uv = mla_absorb(cfg, p)
    q_lat = torch.einsum("bshd,rhd->bshr", _bf16(qn),
                         _bf16(w_uk)).to(hn.dtype)
    ctx_lat = attend_latent(q_lat, qr, ckv_new, krope_new)
    out = torch.einsum("bshr,rhd->bshd", _bf16(ctx_lat), _bf16(w_uv))
    return dense(p["wo"], out.reshape(b, s, h * dv).to(hn.dtype))


def mla_layer(cfg, p, x, positions, attend_latent, mlp_fn=None):
    """One full MLA transformer layer over the latent, the sibling of
    :func:`gqa_layer`: the engine's paged prefill and decode.

    ``attend_latent(q_lat, qr, ckv_new, krope_new) -> ctx_lat`` receives
    the absorbed queries (B, S, H, r), the roped rope-queries (B, S, H,
    dr) and this call's latent payloads ``ckv_new`` (B, S, r) / ``krope_new``
    (B, S, dr), and returns the latent context (B, S, H, r). The products
    with W_UK and W_UV take bfloat16 operands and accumulate in float32, as
    the reference's do.
    """
    hn = rms_norm(p["ln1"], x, cfg.norm_eps)
    y = x + mla_attention(cfg, p["attn"], hn, positions, attend_latent)
    h2 = rms_norm(p["ln2"], y, cfg.norm_eps)
    return y + (mlp(p["mlp"], h2) if mlp_fn is None else mlp_fn(p["mlp"], h2))


def mla_prefill_cache(cfg, p, x, positions, capacity: int):
    """The latent cache of a full prefill pass, padded to ``capacity``
    slots with position -1 (``attention.py:506-519``). x: (B, S, D), the
    layer's normed input; positions: (S,)."""
    b, s, _ = x.shape
    ckv, krope = _mla_latent(cfg, p, x, positions)
    pad = capacity - s
    pos = positions.to(torch.int32).expand(b, s)
    return MLACache(ckv=F.pad(ckv, (0, 0, 0, pad)),
                    krope=F.pad(krope, (0, 0, 0, pad)),
                    pos=F.pad(pos, (0, pad), value=-1))
