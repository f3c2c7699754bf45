"""Plain float32 pieces of the references, and the weights they share with
the program.

The references are written from the published architectures, as the
configuration file states them, in plain PyTorch on float32 with TF32
off. They import nothing of the program. :class:`Weights` draws a model's
weights from the run's seed on the device in the type they are served in,
in a few large draws into one buffer, and lays them out as the tree the
program's engine takes; the reference reads the same tensors and converts
each layer to float32 as it needs it.

``Quant`` is the control of the correctness check: every product with a
weight computed on float8 (e4m3) operands, activations scaled per row and
weights per output column, as an fp8 serving path would compute them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

F8 = torch.float8_e4m3fn
F8_MAX = 448.0
# elements per draw: one draw fills 2 GiB of bf16 at most
DRAW = 1 << 30


def seed_of(seed: int) -> int:
    """The run's seed as a generator seed (any whole number)."""
    return seed % (1 << 63)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Weights:
    """Leaves declared with :meth:`add`, then drawn together by
    :meth:`draw`: ``normal * scale`` (``kind="normal"``), a bias ``normal *
    0.02`` (``"bias"``) or a norm scale ``1 + normal * 0.1`` (``"norm"``).
    Leaves in ``dtype`` share one buffer, float32 leaves another."""

    def __init__(self, dtype: torch.dtype, device):
        self.dtype, self.device = dtype, torch.device(device)
        self.leaves: List[Tuple[dict, str, tuple, str, float, torch.dtype]] \
            = []

    def add(self, parent: dict, key: str, shape, kind: str = "normal",
            scale: float = 1.0, dtype: Optional[torch.dtype] = None):
        self.leaves.append((parent, key, tuple(shape), kind, scale,
                            dtype or self.dtype))

    def draw(self, seed: int) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed_of(seed))
        for dt in sorted({l[5] for l in self.leaves}, key=str):
            mine = [l for l in self.leaves if l[5] == dt]
            total = sum(math.prod(l[2]) for l in mine)
            flat = torch.empty(total, dtype=dt, device=self.device)
            for i in range(0, total, DRAW):
                flat[i:i + DRAW].normal_(generator=gen)
            at = 0
            for parent, key, shape, kind, scale, _ in mine:
                n = math.prod(shape)
                leaf = flat[at:at + n].view(shape)
                at += n
                if kind == "normal":
                    leaf.mul_(scale)
                elif kind == "bias":
                    leaf.mul_(0.02)
                elif kind == "norm":
                    leaf.mul_(0.1).add_(1.0)
                else:
                    raise ValueError(f"unknown leaf kind {kind!r}")
                parent[key] = leaf


def layer_of(tree, i: Optional[int]):
    """Layer ``i`` of a stacked subtree (``i`` None: not stacked), as
    float32 copies."""
    if isinstance(tree, dict):
        return {k: layer_of(v, i) for k, v in tree.items()}
    t = tree if i is None else tree[i]
    return t.float()


class Quant:
    """float8 e4m3 operands for every product with a weight."""

    @staticmethod
    def _q(x, dim):
        s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / F8_MAX
        return (x / s).to(F8).float() * s

    def mm(self, x, w):
        return self._q(x, -1) @ self._q(w, 0)


def mm(x, w, quant: Optional[Quant] = None):
    return x @ w if quant is None else quant.mm(x, w)


def dense(p, x, quant=None):
    y = mm(x, p["w"], quant)
    return y + p["b"] if "b" in p else y


def rms_norm(p, x, eps: float):
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * p["scale"]
    return y + p["b"] if "b" in p else y


def rope(x, positions, theta: float):
    """Rotary embedding, rotating the first half of the last axis against
    the second (GPT-NeoX). x: (S, ..., D); positions: (S,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = positions.float()[:, None] * inv
    ang = ang.reshape(ang.shape[:1] + (1,) * (x.dim() - 2) + ang.shape[1:])
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float, window: Optional[int] = None,
                     head_block: int = 16):
    """One sequence. q: (S, H, dk); k: (S, Hkv, dk); v: (S, Hkv, dv);
    query ``i`` attends keys ``j <= i`` (and ``j > i - window``)."""
    s, h, _ = q.shape
    g = h // k.shape[1]
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    out = []
    for h0 in range(0, h, head_block):
        qb = q[:, h0:h0 + head_block]
        kv_heads = torch.arange(h0, h0 + qb.shape[1], device=q.device) // g
        kb, vb = k[:, kv_heads], v[:, kv_heads]
        scores = torch.einsum("qhd,khd->hqk", qb, kb) * scale
        scores = scores.masked_fill(~mask, float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1),
                                vb))
    return torch.cat(out, dim=1)


def unembed_at(table, x, vocab: int, quant=None):
    """Logits (n, vocab) of the rows ``x`` (n, d) over the first ``vocab``
    rows of ``table``, in float32, a block of rows at a time."""
    out = []
    for i in range(0, table.shape[0], 8192):
        out.append(mm(x, table[i:i + 8192].float().T, quant))
    return torch.cat(out, dim=1)[:, :vocab]


def spans(seqs: Sequence[Sequence[int]]):
    """Start and end of each sequence in their concatenation."""
    at, out = 0, []
    for s in seqs:
        out.append((at, at + len(s)))
        at += len(s)
    return out


def rows_of_interest(seqs, firsts) -> torch.Tensor:
    """Indices, in the concatenation, of the positions whose logits are
    compared: from ``firsts[i]`` to the end of sequence ``i``."""
    idx = []
    for (a, b), f in zip(spans(seqs), firsts):
        idx.extend(range(a + f, b))
    return torch.tensor(idx, dtype=torch.long)
