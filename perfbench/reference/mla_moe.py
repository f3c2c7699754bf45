"""Plain float32 reference of a DeepSeek-V2 decoder: multi-head latent
attention (MLA) and a mixture of experts after ``first_k_dense_replace``
dense layers.

MLA, written in its decompressed form (DeepSeek-V2, section 2.1): the
query through the low-rank ``q_lora_rank`` path and its norm, split into
a part without position and a rotary part; the key-value latent
``kv_lora_rank`` normed, lifted to per-head keys and values, and one
rotary key shared by all heads; scores scaled by ``1 / sqrt(dn + dr)``.
The MoE: a softmax router over ``n_routed_experts``, the
``num_experts_per_tok`` largest, their weights renormalised to sum to one
where ``norm_topk_prob`` holds (then scaled by
``routed_scaling_factor``), SwiGLU experts of ``moe_intermediate_size``,
and ``n_shared_experts`` shared experts as one SwiGLU of that many times
the width, applied to every token. No token is dropped.

Other keys: ``num_hidden_layers``, ``hidden_size``,
``num_attention_heads``, ``intermediate_size`` (the dense layers),
``vocab_size``, ``rms_norm_eps``, ``rope_theta``, ``topk_method`` (only
``greedy``: the largest over all experts), ``rope_scaling`` (only YaRN at
``factor`` 1 or none: at factor 1 YaRN moves no frequency and its mscale
terms are 1, so it is the plain rotary embedding).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import common as C


def make_weights(conf, seed: int, dtype, device):
    """The engine's parameter tree, drawn from ``seed`` (scales as in
    :func:`perfbench.reference.dense_gqa.make_weights`; the router in
    float32): a segment of the dense layers and one of the MoE layers,
    each stacked along a leading axis where it holds several layers."""
    L, d = conf["num_hidden_layers"], conf["hidden_size"]
    h, r, qr = (conf["num_attention_heads"], conf["kv_lora_rank"],
                conf["q_lora_rank"])
    dn, dr, dv = (conf["qk_nope_head_dim"], conf["qk_rope_head_dim"],
                  conf["v_head_dim"])
    e, ff = conf["n_routed_experts"], conf["moe_intermediate_size"]
    ff_sh = conf["n_shared_experts"] * ff
    k_dense = conf["first_k_dense_replace"]
    v = conf["vocab_size"]
    w = C.Weights(dtype, device)

    def linear(parent, key, lead, d_in, d_out, dtype=None):
        p = parent[key] = {}
        w.add(p, "w", lead + (d_in, d_out), scale=1.0 / math.sqrt(d_in),
              dtype=dtype)

    def norm(parent, key, lead, n):
        p = parent[key] = {}
        w.add(p, "scale", lead + (n,), "norm")

    def swiglu(parent, key, lead, width):
        p = parent[key] = {}
        linear(p, "up", lead, d, width)
        linear(p, "down", lead, width, d)
        linear(p, "gate", lead, d, width)

    segments = []
    for n, moe in ((k_dense, False), (L - k_dense, True)):
        if n == 0:
            continue
        lead = (n,) if n > 1 else ()
        seg = {"attn": {}}
        norm(seg, "ln1", lead, d)
        norm(seg, "ln2", lead, d)
        a = seg["attn"]
        linear(a, "wkv_a", lead, d, r + dr)
        norm(a, "kv_norm", lead, r)
        linear(a, "wkv_b", lead, r, h * (dn + dv))
        linear(a, "wo", lead, h * dv, d)
        linear(a, "wq_a", lead, d, qr)
        norm(a, "q_norm", lead, qr)
        linear(a, "wq_b", lead, qr, h * (dn + dr))
        if moe:
            m = seg["mlp"] = {}
            linear(m, "router", lead, d, e, dtype=torch.float32)
            w.add(m, "gate", lead + (e, d, ff), scale=1.0 / math.sqrt(d))
            w.add(m, "up", lead + (e, d, ff), scale=1.0 / math.sqrt(d))
            w.add(m, "down", lead + (e, ff, d), scale=1.0 / math.sqrt(ff))
            if ff_sh:
                swiglu(m, "shared", lead, ff_sh)
        else:
            swiglu(seg, "mlp", lead, conf["intermediate_size"])
        segments.append((n, moe, seg))
    tree = {"embed": {}, "segments": [s for _, _, s in segments]}
    w.add(tree["embed"], "table", ((v + 511) // 512 * 512, d), scale=0.02)
    norm(tree, "final_norm", (), d)
    w.draw(seed)
    return tree


def _swiglu(p, x, quant):
    return C.dense(p["down"], F.silu(C.dense(p["gate"], x, quant))
                   * C.dense(p["up"], x, quant), quant)


def _attention(conf, p, x, pos, seqs, quant):
    h, r = conf["num_attention_heads"], conf["kv_lora_rank"]
    dn, dr, dv = (conf["qk_nope_head_dim"], conf["qk_rope_head_dim"],
                  conf["v_head_dim"])
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    q = C.dense(p["wq_b"], C.rms_norm(p["q_norm"],
                                      C.dense(p["wq_a"], x, quant), eps),
                quant).view(-1, h, dn + dr)
    q = torch.cat([q[..., :dn], C.rope(q[..., dn:], pos, theta)], -1)
    kv = C.dense(p["wkv_a"], x, quant)
    ckv = C.rms_norm(p["kv_norm"], kv[:, :r], eps)
    k_rope = C.rope(kv[:, r:], pos, theta)
    kvb = C.dense(p["wkv_b"], ckv, quant).view(-1, h, dn + dv)
    k = torch.cat([kvb[..., :dn], k_rope[:, None].expand(-1, h, dr)], -1)
    vv = kvb[..., dn:]
    ctx = torch.cat([C.causal_attention(q[a:b], k[a:b], vv[a:b],
                                        1.0 / math.sqrt(dn + dr))
                     for a, b in C.spans(seqs)])
    return C.dense(p["wo"], ctx.reshape(-1, h * dv), quant)


def _moe(conf, p, i, x, quant):
    """Routed experts (dropless) plus the shared ones; expert weights are
    taken to float32 one expert at a time."""
    k = conf["num_experts_per_tok"]
    if conf.get("topk_method", "greedy") != "greedy":
        raise NotImplementedError(conf["topk_method"])
    probs = torch.softmax(x @ C.layer_of(p["router"], i)["w"], dim=-1)
    topv, topi = probs.topk(k, dim=-1)
    if conf.get("norm_topk_prob"):
        topv = topv / topv.sum(-1, keepdim=True)
    topv = topv * conf.get("routed_scaling_factor", 1.0)
    y = torch.zeros_like(x)
    for e in torch.unique(topi).tolist():
        tok, slot = (topi == e).nonzero(as_tuple=True)
        pick = (lambda t: t[e]) if i is None else (lambda t: t[i, e])
        ex = {n: {"w": pick(p[n]).float()} for n in ("gate", "up", "down")}
        y.index_add_(0, tok, topv[tok, slot, None]
                     * _swiglu(ex, x[tok], quant))
    if "shared" in p:
        y = y + _swiglu(C.layer_of(p["shared"], i), x, quant)
    return y


@torch.no_grad()
def logits(conf, tree, seqs, firsts, quant=None):
    """float32 logits (n, vocab) at positions ``firsts[i]..`` of each token
    sequence in ``seqs``, the rows in order; one layer at a time over all
    sequences."""
    C.no_tf32()
    if (conf.get("rope_scaling") or {}).get("factor", 1) != 1:
        raise NotImplementedError("rope_scaling: only YaRN at factor 1")
    eps = conf["rms_norm_eps"]
    k_dense = conf["first_k_dense_replace"]
    L = conf["num_hidden_layers"]
    table = tree["embed"]["table"]
    dev = table.device
    toks = torch.tensor([t for s in seqs for t in s], dtype=torch.long,
                        device=dev)
    pos = torch.cat([torch.arange(len(s), device=dev) for s in seqs])
    x = table[toks].float()
    plan = [(k_dense, False), (L - k_dense, True)]
    segs = iter(tree["segments"])
    for n, moe in plan:
        if n == 0:
            continue
        seg = next(segs)
        for j in range(n):
            i = j if n > 1 else None
            pa = C.layer_of({"ln1": seg["ln1"], "ln2": seg["ln2"],
                             "attn": seg["attn"]}, i)
            x = x + _attention(conf, pa["attn"], C.rms_norm(pa["ln1"], x, eps),
                               pos, seqs, quant)
            hn = C.rms_norm(pa["ln2"], x, eps)
            if moe:
                x = x + _moe(conf, seg["mlp"], i, hn, quant)
            else:
                x = x + _swiglu(C.layer_of(seg["mlp"], i), hn, quant)
            del pa
    rows = C.rows_of_interest(seqs, firsts).to(dev)
    fin = C.layer_of(tree["final_norm"], None)
    xo = C.rms_norm(fin, x[rows], eps)
    return C.unembed_at(table, xo, conf["vocab_size"], quant)
