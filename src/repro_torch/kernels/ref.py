"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper and the yardstick each CUDA kernel is held against on the card."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.attention import blockwise_attention

NEG_INF = -1e30  # the Pallas kernel's mask value


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    page_size: int, window: Optional[int] = None,
                    return_partials: bool = False,
                    scale: Optional[float] = None):
    """Decode attention over a paged KV cache, in float32, scores scaled
    by ``scale`` (1/sqrt(Dh) where None).

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
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * \
        (1.0 / dh ** 0.5 if scale is None else scale)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * valid[:, None, None, :]
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v) / l.clamp_min(1e-9)[..., None]
    out = o.reshape(b, h, dh).to(q.dtype)
    if return_partials:
        return out, m.reshape(b, h), l.reshape(b, h)
    return out


def merge_partials(os, ms, ls):
    """Merge attention partials over disjoint key ranges: the plain version
    of ``paged_attention``'s merge of its context splits, by the rule of
    ``repro.core.distkv.dist_attention.merge_partials_tree``.

    os: sequence of unnormalised outputs (..., Dh); ms, ls: sequences of
    the matching running max and sum of exponentials (...), float32. A
    partial over no valid key has o = 0, m = -1e30 and l = 0. Returns the
    normalised output (l floored at 1e-9) and the merged m and l (the
    global max and the sum rescaled to it), all float32.
    """
    m = torch.stack([x.float() for x in ms]).amax(dim=0)
    o = torch.zeros_like(os[0], dtype=torch.float32)
    l = torch.zeros_like(m)
    for oi, mi, li in zip(os, ms, ls):
        corr = torch.exp(mi.float() - m)
        l = l + li.float() * corr
        o = o + oi.float() * corr[..., None]
    return o / l.clamp_min(1e-9)[..., None], m, l


def flash_prefill(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None):
    """Flash-attention forward, as the Pallas kernel ``_flash_kernel``
    computes it: float32 math on upcast inputs, unrounded probabilities,
    output in q's type; scores scaled by ``scale`` (1/sqrt(Dh) where
    None).

    q: (B, S, H, Dh); k, v: (B, Skv, Hkv, Dh), H a multiple of Hkv (GQA).
    Key ``k`` is valid for query ``i`` iff ``k <= i`` (causal) and, with a
    window, ``k > i - window``. A row with no valid key returns zeros: the
    sum of exponentials is clamped at 1e-9, as the Pallas kernel does.
    """
    b, s, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, dh).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) \
        * (1.0 / dh ** 0.5 if scale is None else scale)
    qpos = torch.arange(s, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    valid = torch.ones(s, skv, dtype=torch.bool, device=q.device)
    if causal:
        valid &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        valid &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * valid
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float())
    return o.reshape(b, s, h, dh).to(q.dtype)


def prefill_attention_paged(q, k_pool, v_pool, page_ids, *, q_offset: int,
                            window: Optional[int] = None,
                            scale: Optional[float] = None):
    """One prefill chunk's causal attention over a paged KV pool, exactly
    as ``PagedEngine._prefill_chunk`` computed it before the kernel: gather
    the context pages, then ``models.attention.blockwise_attention`` with
    the chunk's offset.

    q: (1, S, H, Dh), the chunk's queries at absolute positions
    ``[q_offset, q_offset + S)``; pools: (P, ps, Hkv, Dh); page_ids: (n,)
    the pages covering context positions ``[0, n * ps)`` in order, with
    ``q_offset + S <= n * ps``. Keys past a query's position are masked,
    so the pool's contents past ``q_offset + S`` never reach a result.
    Rounds q, k, v and the normalised probabilities to bfloat16 and
    accumulates in float32; output in q's type.
    """
    _, s, h, dh = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    n = page_ids.shape[0]
    idx = page_ids.long()
    k = k_pool[idx].reshape(1, n * ps, hkv, dh)
    v = v_pool[idx].reshape(1, n * ps, hkv, dh)
    return blockwise_attention(q, k, v, causal=True, window=window,
                               q_offset=q_offset, scale=scale)


def prefill_attention(q, k, v, *, window: Optional[int] = None,
                      causal: bool = True, scale: Optional[float] = None):
    """Attention of whole sequences, as the reference's ``Model.prefill``
    computes it: ``blockwise_attention`` (bf16 q, k, v and probabilities,
    float32 sums). q: (B, S, H, Dh); k, v: (B, Skv, Hkv, Dh), Skv = S when
    causal. Causal: key ``j`` is valid for query ``i`` iff ``j <= i`` and,
    with a window, ``j > i - window``; otherwise every key is valid (an
    encoder's self-attention, a decoder's cross-attention). Output in q's
    type; zeros where there is no key. ``scale``: the softmax scale,
    1/sqrt(Dh) where None."""
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def ssd_scan(x, dt, A, B, C, *, chunk: int, initial_state=None):
    """Mamba2 SSD chunked scan: the arithmetic of the Pallas kernel
    ``_ssd_kernel`` and of ``repro.models.ssm.ssd_chunked``, with the
    inter-chunk recurrence as a loop over chunks.

    x: (b, l, h, p) any float; dt: (b, l, h) float32 after softplus; A:
    (h,) float32, negative; B, C: (b, l, g, n), head ``i`` reading group
    ``i // (h // g)``; ``initial_state`` (b, h, p, n), the state before
    token 0 (zeros where None). Any ``l``: a short last chunk is padded
    with dt = 0 and zeros, which is exact (its decay is 1 and its
    contribution 0). Returns y (b, l, h, p) float32 and the final state
    (b, h, p, n) float32.
    """
    b, l0, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = -l0 % chunk
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, B, C))
    l = l0 + pad
    nc, rep = l // chunk, h // g
    dt = dt.float()
    xdt = (x.float() * dt[..., None]).reshape(b, nc, chunk, h, p)
    a_cum = torch.cumsum((dt * A.float()).reshape(b, nc, chunk, h), dim=2)
    Bh = B.float().repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    Ch = C.float().repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)

    # intra-chunk: Lmat[i, j] = exp(cum_i - cum_j) for j <= i
    ac = a_cum.transpose(2, 3)  # (b, nc, h, chunk)
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp((ac[..., :, None] - ac[..., None, :])
                     .masked_fill(~tril, float("-inf")))
    scores = torch.einsum("bzihn,bzjhn->bzhij", Ch, Bh) * lmat
    y = torch.einsum("bzhij,bzjhp->bzihp", scores, xdt)

    # each chunk's own state, then the recurrence across chunks
    decay_out = torch.exp(a_cum[:, :, -1:, :] - a_cum)
    states = torch.einsum("bzlh,bzlhn,bzlhp->bzhpn", decay_out, Bh, xdt)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (b, nc, h)
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state.float()
    decay_in = torch.exp(a_cum)
    for z in range(nc):
        y[:, z] += torch.einsum("blhn,blh,bhpn->blhp", Ch[:, z],
                                decay_in[:, z], state)
        state = state * chunk_decay[:, z, :, None, None] + states[:, z]
    return y.reshape(b, l, h, p)[:, :l0], state


def ssd_scan_ref(x, dt, A, B, C, initial_state=None):
    """Sequential SSD recurrence, one token at a time: the oracle of
    ``repro.kernels.ref.ssd_scan_ref``. Same arguments as
    :func:`ssd_scan` without ``chunk``; returns y and the final state."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    xf, dt = x.float(), dt.float()
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state.float()
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, t] * A)
        state = state * decay[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t] * dt[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1), state
