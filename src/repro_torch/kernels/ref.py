"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper and the yardstick each CUDA kernel is held against on the card."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # the Pallas kernel's mask value


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    page_size: int, window: Optional[int] = None,
                    return_partials: bool = False):
    """Decode attention over a paged KV cache, in float32.

    q: (B, H, Dh); pages: (P, ps, Hkv, Dh); block_tables: (B, n) int;
    context_lens: (B,) int. Key position ``pos`` of row ``b`` is valid iff
    ``pos < ctx_b`` and, with a window, ``pos > ctx_b - 1 - window``.
    Returns (B, H, Dh) in q's type, and with ``return_partials`` also the
    float32 running max ``m`` and sum of exponentials ``l``, each (B, H).
    A row with no valid position (``ctx_len == 0``) returns zeros, m =
    -1e30 and l = 0, as the Pallas kernel does (``repro.kernels.ref``'s
    oracle returns NaN there).
    """
    b, h, dh = q.shape
    hkv = k_pages.shape[2]
    g = h // hkv
    n = block_tables.shape[1]
    smax = n * page_size
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, smax, hkv, dh).float()
    v = v_pages[bt].reshape(b, smax, hkv, dh).float()
    pos = torch.arange(smax, device=q.device)
    lens = context_lens.long()[:, None]
    valid = pos[None, :] < lens
    if window is not None:
        valid &= pos[None, :] > lens - 1 - window
    qg = q.reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * (1.0 / dh ** 0.5)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * valid[:, None, None, :]
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v) / l.clamp_min(1e-9)[..., None]
    out = o.reshape(b, h, dh).to(q.dtype)
    if return_partials:
        return out, m.reshape(b, h), l.reshape(b, h)
    return out
