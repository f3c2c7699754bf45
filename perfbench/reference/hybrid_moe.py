"""Plain float32 reference of a Granite 4.0-H decoder (``model_type``
``granitemoehybrid``): Mamba-2 and attention mixers in one stack, as its
``layer_types`` lists them, each layer followed by a mixture of experts
and a shared MLP.

Each layer, pre-norm on both branches (RMSNorm, ``rms_norm_eps``):
``h = h + residual_multiplier * mixer(norm(h))``, then ``h = h +
residual_multiplier * (moe(norm(h)) + shared(norm(h)))``. The embedded
tokens are multiplied by ``embedding_multiplier``; the logits (through
the tied embedding) are divided by ``logits_scaling``.

* Mamba-2 (arXiv:2405.21060): ``in_proj`` (no bias) to [z, xBC, dt];
  a depthwise causal conv of ``mamba_d_conv`` with bias, then SiLU, over
  xBC; dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD over x dt,
  A dt and the ``mamba_n_groups`` B and C, written after the paper's
  minimal chunked listing (``ssd_minimal_discrete``: the intra-chunk
  quadratic form, each chunk's state, the recurrence across chunks and
  the states' readout) in chunks of ``mamba_chunk_size``, a sequence
  padded to whole chunks with zeros (dt = 0: no decay, no contribution);
  y + D x; y times SiLU(z), RMS-normalised over the inner width and
  scaled; ``out_proj`` (no bias).
* Attention: ``num_attention_heads`` queries over ``num_key_value_heads``
  keys and values of 128 (``hidden_size / num_attention_heads``), no
  position embedding (``position_embedding_type`` "nope"), causal, the
  softmax scaled by ``attention_multiplier``; no biases.
* MoE: a softmax over the ``num_experts_per_tok`` largest of the
  router's ``num_local_experts`` logits (no bias), every expert a SwiGLU
  of ``intermediate_size``; no token is dropped. The shared MLP: a SwiGLU
  of ``shared_intermediate_size`` on every token.

Departures from the published model: the weights are drawn from the
run's seed (:func:`make_weights`), not trained; the conv's weights are
kept as (width, channels), the published ``conv1d`` weight transposed;
the experts' gate and up products are separate matrices, the published
``input_linear`` split in two; computation is float32 throughout with
TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import common as C


def _plan(conf):
    """(number of layers, mixer) of each run of one mixer in
    ``layer_types``: the segments of the program's parameter tree."""
    runs = []
    for t in conf["layer_types"][:conf["num_hidden_layers"]]:
        if runs and runs[-1][1] == t:
            runs[-1][0] += 1
        else:
            runs.append([1, t])
    return [(n, t) for n, t in runs]


def _widths(conf):
    d = conf["hidden_size"]
    din = conf["mamba_expand"] * d
    gn = conf["mamba_n_groups"] * conf["mamba_d_state"]
    return d, din, gn, conf["mamba_n_heads"]


def make_weights(conf, seed: int, dtype, device):
    """The engine's parameter tree, drawn from ``seed``: a segment per run
    of one mixer, its layers stacked along a leading axis where it holds
    several. Matrices normal x 1/sqrt(fan-in) (the router in float32),
    norm scales 1 + 0.1 normal, the embedding 0.02 / embedding_multiplier
    normal, so that the embedded tokens are 0.02 normal as the other
    references draw them (at 0.02 the x12 embedding outweighs every
    layer's output in the last hidden state, and through the tied
    unembedding every position's largest logit is its own token's: the
    model repeats its input, and the check's control reads no gap); a
    Mamba-2
    mixer's conv weights 0.3 normal, its conv bias 0.02 normal, and, in
    float32, D 1 + 0.1 normal, A_log 1 + 0.5 normal (decay rates
    exp(A_log) of about 1 to 7) and dt_bias -4 + 0.02 normal (dt of about
    0.02 to 0.1 per token, so that a state remembers tens to hundreds of
    tokens)."""
    d, din, gn, h = _widths(conf)
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    dh = d // hq
    e, ff = conf["num_local_experts"], conf["intermediate_size"]
    ff_sh = conf["shared_intermediate_size"]
    width = conf["mamba_d_conv"]
    v = conf["vocab_size"]
    f32 = torch.float32
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

    segments, shifts = [], []
    for n, mixer in _plan(conf):
        lead = (n,) if n > 1 else ()
        seg = {}
        norm(seg, "ln1", lead, d)
        norm(seg, "ln2", lead, d)
        if mixer == "mamba":
            m = seg["ssm"] = {}
            linear(m, "in_proj", lead, d, 2 * din + 2 * gn + h)
            w.add(m, "conv_w", lead + (width, din + 2 * gn), scale=0.3)
            w.add(m, "conv_b", lead + (din + 2 * gn,), "bias")
            w.add(m, "dt_bias", lead + (h,), "bias", dtype=f32)
            w.add(m, "A_log", lead + (h,), scale=0.5, dtype=f32)
            w.add(m, "D", lead + (h,), "norm", dtype=f32)
            w.add(m, "norm_scale", lead + (din,), "norm")
            linear(m, "out_proj", lead, din, d)
            shifts.append(m)
        else:
            a = seg["attn"] = {}
            linear(a, "wq", lead, d, hq * dh)
            linear(a, "wk", lead, d, hkv * dh)
            linear(a, "wv", lead, d, hkv * dh)
            linear(a, "wo", lead, hq * dh, d)
        moe = seg["mlp"] = {}
        linear(moe, "router", lead, d, e, dtype=f32)
        w.add(moe, "gate", lead + (e, d, ff), scale=1.0 / math.sqrt(d))
        w.add(moe, "up", lead + (e, d, ff), scale=1.0 / math.sqrt(d))
        w.add(moe, "down", lead + (e, ff, d), scale=1.0 / math.sqrt(ff))
        swiglu(moe, "shared", lead, ff_sh)
        segments.append(seg)
    tree = {"embed": {}, "segments": segments}
    w.add(tree["embed"], "table", ((v + 511) // 512 * 512, d),
          scale=0.02 / conf["embedding_multiplier"])
    norm(tree, "final_norm", (), d)
    w.draw(seed)
    for m in shifts:
        m["dt_bias"].sub_(4.0)
        m["A_log"].add_(1.0)
    return tree


def _swiglu(p, x, quant):
    return C.dense(p["down"], F.silu(C.dense(p["gate"], x, quant))
                   * C.dense(p["up"], x, quant), quant)


def _segsum(a):
    """a (..., T) -> (..., T, T): entry (i, j) the sum of a[j+1..i] for
    j <= i, -inf above the diagonal (the listing's ``segsum``)."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return x.masked_fill(~keep, -math.inf)


def ssd(x, a, b, c, chunk: int):
    """The SSD of one sequence from a zero state, in the minimal listing's
    four steps. x: (T, H, P), the input times dt; a: (T, H), A times dt;
    b, c: (T, G, N), head h reading group h // (H / G). Returns y (T, H,
    P) and the final state (H, P, N)."""
    t, h, p = x.shape
    g, n = b.shape[1], b.shape[2]
    pad = -t % chunk
    x, a, b, c = (F.pad(z, (0, 0) * (z.dim() - 1) + (0, pad))
                  for z in (x, a, b, c))
    k = (t + pad) // chunk
    rep = h // g
    x = x.view(k, chunk, h, p)
    b = b.view(k, chunk, g, n).repeat_interleave(rep, dim=2)
    c = c.view(k, chunk, g, n).repeat_interleave(rep, dim=2)
    a = a.view(k, chunk, h).permute(2, 0, 1)  # (h, k, l)
    a_cum = torch.cumsum(a, dim=-1)
    # 1. within each chunk: y_i = sum_{j <= i} (c_i . b_j) L_ij x_j
    lmat = torch.exp(_segsum(a))  # (h, k, l, l)
    scores = torch.einsum("klhn,kshn->hkls", c, b) * lmat
    y_diag = torch.einsum("hkls,kshp->klhp", scores, x)
    # 2. each chunk's own state
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (h, k, l)
    states = torch.einsum("klhn,hkl,klhp->khpn", b, decay_states, x)
    # 3. the state entering each chunk, by the recurrence across chunks
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    decay_chunk = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    new = torch.einsum("hzk,khpn->zhpn", decay_chunk, states)
    entering, final = new[:-1], new[-1]
    # 4. each entering state read out at each position of its chunk
    y_off = torch.einsum("klhn,hkl,khpn->klhp", c, torch.exp(a_cum),
                         entering)
    return (y_diag + y_off).reshape(k * chunk, h, p)[:t], final


def _mamba(conf, p, x, seqs, quant):
    """The Mamba-2 mixer over the concatenated sequences (S, d)."""
    d, din, gn, h = _widths(conf)
    g, n = conf["mamba_n_groups"], conf["mamba_d_state"]
    pdim = conf["mamba_d_head"]
    width = conf["mamba_d_conv"]
    proj = C.dense(p["in_proj"], x, quant)
    z, xbc, dt = proj[:, :din], proj[:, din:2 * din + 2 * gn], \
        proj[:, 2 * din + 2 * gn:]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    out = []
    for s0, s1 in C.spans(seqs):
        u = F.pad(xbc[s0:s1], (0, 0, width - 1, 0))
        conv = sum(u[i:i + s1 - s0] * p["conv_w"][i] for i in range(width))
        conv = F.silu(conv + p["conv_b"])
        xs = conv[:, :din].reshape(-1, h, pdim)
        bs = conv[:, din:din + gn].reshape(-1, g, n)
        cs = conv[:, din + gn:].reshape(-1, g, n)
        dts = dt[s0:s1]
        y, _ = ssd(xs * dts[..., None], dts * A, bs, cs,
                   conf["mamba_chunk_size"])
        out.append((y + xs * p["D"][:, None]).reshape(-1, din))
    y = torch.cat(out) * F.silu(z)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True)
                        + conf["rms_norm_eps"]) * p["norm_scale"]
    return C.dense(p["out_proj"], y, quant)


def _attention(conf, p, x, seqs, quant):
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    dh = conf["hidden_size"] // hq
    q = C.dense(p["wq"], x, quant).view(-1, hq, dh)
    k = C.dense(p["wk"], x, quant).view(-1, hkv, dh)
    v = C.dense(p["wv"], x, quant).view(-1, hkv, dh)
    ctx = torch.cat([C.causal_attention(q[a:b], k[a:b], v[a:b],
                                        conf["attention_multiplier"])
                     for a, b in C.spans(seqs)])
    return C.dense(p["wo"], ctx.reshape(-1, hq * dh), quant)


def _moe(conf, p, i, x, quant):
    """The routed experts (dropless; weights taken to float32 one expert
    at a time) plus the shared MLP. The router stays in float32 under the
    control, as the program's does."""
    k = conf["num_experts_per_tok"]
    logits = x @ C.layer_of(p["router"], i)["w"]
    topl, topi = logits.topk(k, dim=-1)
    gates = torch.softmax(topl, dim=-1)
    y = torch.zeros_like(x)
    for e in torch.unique(topi).tolist():
        tok, slot = (topi == e).nonzero(as_tuple=True)
        pick = (lambda t: t[e]) if i is None else (lambda t: t[i, e])
        ex = {nm: {"w": pick(p[nm]).float()} for nm in ("gate", "up", "down")}
        y.index_add_(0, tok, gates[tok, slot, None]
                     * _swiglu(ex, x[tok], quant))
    return y + _swiglu(C.layer_of(p["shared"], i), x, quant)


@torch.no_grad()
def logits(conf, tree, seqs, firsts, quant=None):
    """float32 logits (n, vocab) at positions ``firsts[i]..`` of each token
    sequence in ``seqs``, the rows in order; one layer at a time over all
    sequences."""
    C.no_tf32()
    if conf.get("position_embedding_type", "nope") != "nope":
        raise NotImplementedError("only NoPE attention")
    eps = conf["rms_norm_eps"]
    r = conf["residual_multiplier"]
    table = tree["embed"]["table"]
    dev = table.device
    toks = torch.tensor([t for s in seqs for t in s], dtype=torch.long,
                        device=dev)
    x = table[toks].float() * conf["embedding_multiplier"]
    for (n, mixer), seg in zip(_plan(conf), tree["segments"]):
        for j in range(n):
            i = j if n > 1 else None
            pl = C.layer_of({key: seg[key] for key in seg if key != "mlp"},
                            i)
            hn = C.rms_norm(pl["ln1"], x, eps)
            if mixer == "mamba":
                x = x + r * _mamba(conf, pl["ssm"], hn, seqs, quant)
            else:
                x = x + r * _attention(conf, pl["attn"], hn, seqs, quant)
            x = x + r * _moe(conf, seg["mlp"], i,
                             C.rms_norm(pl["ln2"], x, eps), quant)
            del pl
    rows = C.rows_of_interest(seqs, firsts).to(dev)
    xo = C.rms_norm(C.layer_of(tree["final_norm"], None), x[rows], eps)
    return C.unembed_at(table, xo, conf["vocab_size"], quant) \
        / conf["logits_scaling"]
