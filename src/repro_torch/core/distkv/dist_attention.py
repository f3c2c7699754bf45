"""DistAttention's micro-attention partials and their log-sum-exp merge
(``repro.core.distkv.dist_attention``), in plain float32 PyTorch.

A partial is attention over a subset of the keys that keeps its softmax
statistics apart: the un-normalised weighted values ``o``, the running
maximum ``m`` and the sum of weights ``l``. Partials over disjoint key sets
merge exactly into the attention over their union. The engine's MLA decode
attends through one partial and the merge, as the reference's does, and a
request served from a zero-copy lease merges its local partial with the
remote one read from the creditor's pages; the mesh parts
(``dist_attention``, the ``pmax`` / ``psum`` merge) come with the sharding
slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_partial(q, k, v, mask, *, scale: Optional[float] = None):
    """Masked multi-query micro-attention partial.

    q: (B, T, H, Dh); k, v: (B, S, Hkv, Dh); mask: (B, T, S) bool, entry
    ``[b, t, s]`` says query ``t`` may attend key ``s``. Returns
    ``(o_unnorm (B, T, H, Dv) float32, m (B, T, H), l (B, T, H))``. A query
    whose keys are all masked gets ``m = -1e30`` and ``l = 0`` (no NaN), so
    the merge gives it zeros.
    """
    b, t, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    qg = q.reshape(b, t, hkv, g, dh).float()
    s = torch.einsum("bthgd,bshd->bthgs", qg, k.float()) * scale
    keep = mask[:, :, None, None, :]
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1)  # (b, t, hkv, g)
    m_safe = m.clamp_min(-1e30)  # fully masked queries must not NaN
    p = torch.exp(s - m_safe[..., None]).masked_fill(~keep, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bthgs,bshd->bthgd", p, v.float())
    return (o.reshape(b, t, h, v.shape[-1]), m_safe.reshape(b, t, h),
            l.reshape(b, t, h))


def merge_partials_tree(os, ms, ls):
    """Merge a list of partials over disjoint key sets into normalised
    attention (B, T, H, Dv)."""
    m_glob = torch.stack(ms).amax(0)
    acc_o = acc_l = 0.0
    for o, m, l in zip(os, ms, ls):
        corr = torch.exp(m - m_glob)
        acc_l = acc_l + l * corr
        acc_o = acc_o + o * corr[..., None]
    return acc_o / acc_l.clamp_min(1e-9)[..., None]
