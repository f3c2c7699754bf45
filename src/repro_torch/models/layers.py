"""PyTorch building blocks, one for one with ``repro.models.layers``.

Parameters are the reference's nested dicts of tensors. ``dense`` weights
keep the reference layout ``(d_in, d_out)`` and are applied as ``x @ w``
(not ``nn.Linear``'s ``(out, in)``), so the weight bridge is a copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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

def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


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


def mlp(p, x):
    up = dense(p["up"], x)
    if "gate" in p:
        h = F.silu(dense(p["gate"], x)) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return dense(p["down"], h)


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def embed(p, tokens):
    return p["table"][tokens]


def unembed(p, x, vocab: int, fp32: bool = False):
    """Vocab logits over the 512-padded table; padded entries are masked to
    the type's lowest value so they never win an argmax or a softmax.
    ``fp32`` projects in float32 (``ArchConfig.logits_fp32``)."""
    table = p["table"]
    if fp32:
        logits = x.float() @ table.float().T
    else:
        logits = x @ table.T
    v_pad = table.shape[0]
    if v_pad != vocab:
        logits[..., vocab:] = torch.finfo(logits.dtype).min
    return logits


def cross_entropy(logits, labels, vocab: int):
    """Mean token loss in float32 (``layers.py:171-186``); labels below 0
    are masked out and the mean is over the valid ones. The padded vocab
    entries are masked already (``unembed``), so ``vocab`` is not read
    here; it is kept for the reference's signature."""
    logits = logits.float()
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    loss = (lse - gold) * valid
    return loss.sum() / valid.sum().clamp_min(1)
