"""PyTorch building blocks, one for one with ``repro.models.layers``.

Parameters are the reference's nested dicts of tensors. ``dense`` weights
keep the reference layout ``(d_in, d_out)`` and are applied as ``x @ w``
(not ``nn.Linear``'s ``(out, in)``), so the weight bridge is a copy.

Every layer takes an optional :class:`ShardingPolicy`, whose hooks sit
where the reference's do. :data:`NO_POLICY` changes nothing;
``repro_torch.launch.sharding.MeshPolicy`` redistributes DTensors at
those hooks, as the reference's constrains their sharding.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard


class ShardingPolicy:
    """The identity policy (``layers.py:19-34``): no constraint, one
    device. A mesh policy overrides the hooks."""

    # GShard groups of the MoE dispatch (one per data shard on a mesh)
    moe_groups = 1
    # the mesh paths run the plain attention and scan: a kernel wrapper
    # refuses a DTensor
    kernels = True

    def act(self, x, kind: str):
        """Constrain an activation. ``kind`` names its logical layout:
        act_bsd, heads_bshd, kv_bshd, ffn_bsf, logits_bsv, kvcache_bskd,
        mlacache_bsr, expert_gecd, expert_gecf, kvrep_bshd, scores_bchs,
        scores_bchgs, ssm_bshp."""
        return x

    def param(self, w, kind: str):
        return w

    def prefers_flat_heads(self, h: int, hkv: int) -> bool:
        return False

    def matmul(self, x, w):
        """``x @ w`` for a dense layer's weight."""
        return x @ self.param(w, "matmul_weight")

    def moe_apply(self, cfg, p, x, return_aux: bool):
        """An expert-parallel MoE in place of the dispatch, or None."""
        return None

    def local_attention(self, q, k, v, *, causal, window, q_offset, scale):
        """``blockwise_attention`` run on each rank's shards, or None."""
        return None

    def token_losses(self, logits, labels):
        """Per-token ``logsumexp(logits) - logits[label]`` over sharded
        logits, or None."""
        return None

    def embed(self, table, tokens):
        """The embedding lookup over a sharded table, or None."""
        return None

    def decode_attention(self, q, k, v, mask, scale: float):
        """Decode attention over a sharded cache in place of the plain
        einsums, or None. q: (B, H, Dk); k: (B, S, Hkv, Dk); v: (B, S,
        Hkv, Dv); mask: (B, S) bool or None; returns (B, H, Dv) float32."""
        return None

    def scope(self):
        """The context a model call runs in."""
        return contextlib.nullcontext()


NO_POLICY = ShardingPolicy()


# ---------------------------------------------------------------------------
# initializers: the reference's distributions, drawn from a torch.Generator
# on the target device. ``lead`` prepends the stacked-layer axis.
# ---------------------------------------------------------------------------

# float32 draws at a time: a full-width stacked weight (llama4's experts
# hold 16 x 5120 x 8192 per layer) is drawn in slices, so the float32
# temporary stays at 512 MiB however large the tensor
NORMAL_CHUNK = 1 << 27


def normal_init(gen, shape, scale, dtype, device):
    """normal * scale of ``shape`` in ``dtype``, drawn in float32."""
    n = math.prod(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, n, NORMAL_CHUNK):
        w = torch.randn(min(NORMAL_CHUNK, n - i), generator=gen,
                        dtype=torch.float32, device=device)
        flat[i:i + w.numel()] = w.mul_(scale)
    return out


def dense_init(gen, d_in: int, d_out: int, dtype, device, *, lead=(),
               bias: bool = False):
    """normal * 1/sqrt(d_in) (``layers.py:41-47``)."""
    p = {"w": normal_init(gen, tuple(lead) + (d_in, d_out),
                          1.0 / math.sqrt(d_in), dtype, device)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype,
                             device=device)
    return p


def norm_init(d: int, dtype, device, *, lead=(), bias: bool = False):
    p = {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d,), dtype=dtype, device=device)
    return p


def mlp_init(gen, d: int, ff: int, dtype, device, *, gated: bool, lead=(),
             bias: bool = False):
    p = {"up": dense_init(gen, d, ff, dtype, device, lead=lead, bias=bias),
         "down": dense_init(gen, ff, d, dtype, device, lead=lead, bias=bias)}
    if gated:
        p["gate"] = dense_init(gen, d, ff, dtype, device, lead=lead,
                               bias=bias)
    return p


def embed_init(gen, vocab: int, d: int, dtype, device):
    """normal * 0.02 over the 512-padded vocab (``layers.py:143-145``)."""
    return {"table": normal_init(gen, (pad_vocab(vocab), d), 0.02, dtype,
                                 device)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def dense(p, x, policy: ShardingPolicy = NO_POLICY, kind=None):
    y = policy.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    if kind is not None:
        y = policy.act(y, kind)
    return y


def split_heads(x, n: int, d: int):
    """``x`` (..., n * d) as (..., n, d). A DTensor whose last axis is
    sharded over more ways than ``n`` divides is made whole along it
    first (GSPMD reshards such a reshape; DTensor refuses it)."""
    if isinstance(x, DTensor):
        last = Shard(x.dim() - 1)
        ways = 1
        for i, pl in enumerate(x.placements):
            if pl == last:
                ways *= x.device_mesh.size(i)
        if n % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if pl == last else pl for pl in x.placements])
    return x.reshape(x.shape[:-1] + (n, d))


def rms_norm(p, x, eps: float = 1e-5):
    """Normalise in float32, cast back to the input type, then scale in the
    model type (the reference's order: ``layers.py:67-74``)."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    y = xf.to(dt) * p["scale"]
    if "b" in p:
        y = y + p["b"]
    return y


def pad_last(x, target: int):
    """Zero-pad the trailing axis of ``x`` up to ``target`` elements."""
    pad = target - x.shape[-1]
    if pad <= 0:
        return x
    return F.pad(x, (0, pad))


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float, *, heads: bool = True):
    """Split-halves (NeoX) rotation in float32. x: (..., S, H, D) if
    ``heads`` else (..., S, D); ``positions``: (S,) or batched (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv
    if heads:
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(p, x, policy: ShardingPolicy = NO_POLICY):
    up = dense(p["up"], x, policy, "ffn_bsf")
    if "gate" in p:
        h = F.silu(dense(p["gate"], x, policy, "ffn_bsf")) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return dense(p["down"], h, policy, "act_bsd")


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def embed(p, tokens, policy: ShardingPolicy = NO_POLICY):
    """The table's rows (a mesh policy looks them up vocab-parallel: each
    rank its own rows, the rest summed in)."""
    x = policy.embed(p["table"], tokens)
    if x is None:
        x = p["table"][tokens]
    return policy.act(x, "act_bsd")


def unembed(p, x, vocab: int, policy: ShardingPolicy = NO_POLICY,
            fp32: bool = False):
    """Vocab logits over the 512-padded table; padded entries are masked to
    the type's lowest value so they never win an argmax or a softmax
    (elementwise over a column index, which shards with the vocab).
    ``fp32`` projects in float32 (``ArchConfig.logits_fp32``)."""
    table = policy.param(p["table"], "unembed_table")
    if fp32:
        logits = x.float() @ table.float().T
    else:
        logits = x @ table.T
    logits = policy.act(logits, "logits_bsv")
    v_pad = table.shape[0]
    if v_pad != vocab:
        cols = torch.arange(v_pad, device=logits.device)
        logits = torch.where(cols < vocab, logits,
                             torch.finfo(logits.dtype).min)
    return logits


def embed_tokens(cfg, p, tokens, policy: ShardingPolicy = NO_POLICY):
    """The embedded tokens, times ``cfg.embedding_multiplier`` where it
    is not 1 (granite-4.0-h's 12)."""
    x = embed(p, tokens, policy)
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def logits_of(cfg, p, x, policy: ShardingPolicy = NO_POLICY):
    """:func:`unembed` at the config's vocabulary and precision, divided
    by ``cfg.logits_scaling`` where it is not 1 (granite-4.0-h's 16)."""
    logits = unembed(p, x, cfg.vocab_size, policy, fp32=cfg.logits_fp32)
    s = cfg.logits_scaling
    return logits if s == 1.0 else logits / s


def residual(cfg, x, branch):
    """``x`` plus a block's output, scaled by ``cfg.residual_multiplier``
    where it is not 1 (granite-4.0-h's 0.22 on each branch)."""
    m = cfg.residual_multiplier
    return x + (branch if m == 1.0 else branch * m)


def token_losses(logits, labels):
    """Per-token ``logsumexp(logits) - logits[label]`` (float32 logits,
    labels >= 0)."""
    return torch.logsumexp(logits, dim=-1) - \
        logits.gather(-1, labels.long()[..., None])[..., 0]


def cross_entropy(logits, labels, vocab: int,
                  policy: ShardingPolicy = NO_POLICY):
    """Mean token loss in float32 (``layers.py:171-186``); labels below 0
    are masked out and the mean is over the valid ones. The padded vocab
    entries are masked already (``unembed``), so ``vocab`` is not read
    here; it is kept for the reference's signature. A mesh policy computes
    the token losses vocab-parallel (:meth:`ShardingPolicy.token_losses`):
    the vocab is never gathered."""
    logits = logits.float()
    valid = labels >= 0
    labels = labels.clamp_min(0)
    tok = policy.token_losses(logits, labels)
    if tok is None:
        tok = token_losses(logits, labels)
    loss = tok * valid
    return loss.sum() / valid.sum().clamp_min(1)
