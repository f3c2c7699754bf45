"""Plain float32 reference of a dense decoder-only transformer with
grouped-query attention: pre-norm residual layers of rotary causal
attention and an MLP, optional biases, tied or untied unembedding.

Configuration keys (a ``config.json``'s names): ``num_hidden_layers``,
``hidden_size``, ``num_attention_heads``, ``num_key_value_heads``,
``head_dim``, ``ffn_dim`` or ``intermediate_size``, ``vocab_size``,
``rms_norm_eps``, ``rope_theta``, ``enable_bias``, ``gated_mlp`` (SwiGLU
when true, else one activation ``activation_function``: ``gelu_tanh`` or
``relu``), ``sliding_window`` (absent or null: none).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import common as C


def _ff(conf) -> int:
    return conf.get("intermediate_size") or conf["ffn_dim"]


def make_weights(conf, seed: int, dtype, device):
    """The engine's parameter tree, drawn from ``seed``: dense weights
    normal / sqrt(fan-in), biases normal * 0.02, norm scales 1 + normal *
    0.1, the embedding normal * 0.02 over the vocabulary padded to 512
    rows; the layers stacked along a leading axis."""
    L, d = conf["num_hidden_layers"], conf["hidden_size"]
    h, hkv, dh = (conf["num_attention_heads"], conf["num_key_value_heads"],
                  conf["head_dim"])
    ff, v = _ff(conf), conf["vocab_size"]
    bias = bool(conf.get("enable_bias"))
    lead = (L,) if L > 1 else ()
    w = C.Weights(dtype, device)

    def linear(parent, key, d_in, d_out):
        p = parent[key] = {}
        w.add(p, "w", lead + (d_in, d_out), scale=1.0 / math.sqrt(d_in))
        if bias:
            w.add(p, "b", lead + (d_out,), "bias")

    def norm(parent, key, lead_=lead):
        p = parent[key] = {}
        w.add(p, "scale", lead_ + (d,), "norm")
        if bias:
            w.add(p, "b", lead_ + (d,), "bias")

    seg = {"attn": {}, "mlp": {}}
    norm(seg, "ln1")
    norm(seg, "ln2")
    linear(seg["attn"], "wq", d, h * dh)
    linear(seg["attn"], "wk", d, hkv * dh)
    linear(seg["attn"], "wv", d, hkv * dh)
    linear(seg["attn"], "wo", h * dh, d)
    linear(seg["mlp"], "up", d, ff)
    linear(seg["mlp"], "down", ff, d)
    if conf.get("gated_mlp", True):
        linear(seg["mlp"], "gate", d, ff)
    tree = {"embed": {}, "segments": [seg]}
    w.add(tree["embed"], "table", ((v + 511) // 512 * 512, d), scale=0.02)
    norm(tree, "final_norm", ())
    w.draw(seed)
    return tree


def _mlp(conf, p, x, quant):
    up = C.dense(p["up"], x, quant)
    if "gate" in p:
        hid = F.silu(C.dense(p["gate"], x, quant)) * up
    elif conf.get("activation_function", "gelu_tanh") == "relu":
        hid = F.relu(up)
    else:
        hid = F.gelu(up, approximate="tanh")
    return C.dense(p["down"], hid, quant)


@torch.no_grad()
def logits(conf, tree, seqs, firsts, quant=None):
    """float32 logits (n, vocab) at positions ``firsts[i]..`` of each token
    sequence in ``seqs`` (every sequence from position 0, causal), the
    rows in order. The layers run one at a time over all sequences."""
    C.no_tf32()
    L, d = conf["num_hidden_layers"], conf["hidden_size"]
    h, hkv, dh = (conf["num_attention_heads"], conf["num_key_value_heads"],
                  conf["head_dim"])
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    window = conf.get("sliding_window")
    table = tree["embed"]["table"]
    dev = table.device
    toks = torch.tensor([t for s in seqs for t in s], dtype=torch.long,
                        device=dev)
    pos = torch.cat([torch.arange(len(s), device=dev) for s in seqs])
    x = table[toks].float()
    seg = tree["segments"][0]
    for i in range(L):
        p = C.layer_of(seg, i if L > 1 else None)
        hn = C.rms_norm(p["ln1"], x, eps)
        q = C.rope(C.dense(p["attn"]["wq"], hn, quant).view(-1, h, dh), pos,
                   theta)
        k = C.rope(C.dense(p["attn"]["wk"], hn, quant).view(-1, hkv, dh),
                   pos, theta)
        v = C.dense(p["attn"]["wv"], hn, quant).view(-1, hkv, dh)
        ctx = torch.cat([C.causal_attention(q[a:b], k[a:b], v[a:b],
                                            1.0 / math.sqrt(dh), window)
                         for a, b in C.spans(seqs)])
        x = x + C.dense(p["attn"]["wo"], ctx.reshape(-1, h * dh), quant)
        x = x + _mlp(conf, p["mlp"], C.rms_norm(p["ln2"], x, eps), quant)
        del p
    rows = C.rows_of_interest(seqs, firsts).to(dev)
    fin = C.layer_of(tree["final_norm"], None)
    xo = C.rms_norm(fin, x[rows], eps)
    return C.unembed_at(table, xo, conf["vocab_size"], quant)
