"""Mamba2 block via SSD (state-space duality) [arXiv:2405.21060], one for
one with ``repro.models.ssm``.

The full-sequence block takes its chunked SSD scan as an argument. The
serving paths (``Model.prefill``, ``Model.forward``) run
:func:`repro_torch.kernels.ssd_scan.ssd_scan`, which launches the CUDA
kernel for CUDA tensors and runs its plain version for CPU tensors; the
training loss runs :func:`ssd_chunked`, the reference's differentiable
scan in plain tensor ops (the kernel has no backward).
Decode is the O(1) recurrent update of a ``(B, H, P, N)`` float32 state
plus a rolling depthwise-conv window, in plain PyTorch (the reference has
no kernel there).

The paged engine keeps each SSM layer's conv windows and states in pools
of one row per decode slot: a prefill chunk continues its sequence from
the row's window and state (:func:`ssm_forward_packed`, every chunk of an
iteration in one call), and a decode step updates the rows that decode in
place (:func:`ssm_step_in`, :func:`ssm_step_update`, :func:`ssm_step_out`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import NO_POLICY, ShardingPolicy, dense, \
    dense_init, split_heads


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, W-1, conv_dim) rolling pre-conv input window
    state: torch.Tensor  # (B, H, P, N) SSD state, float32


def conv_dim(cfg) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def ssm_init(cfg, gen, dtype, device, *, lead=()):
    """The reference's distributions (``ssm.py:26-42``): ``lead`` prepends
    the stacked-layer axis."""
    d, din, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    lead = tuple(lead)
    conv_w = torch.randn(lead + (cfg.ssm_conv_width, conv_dim(cfg)),
                         generator=gen, dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, float(h), h, dtype=torch.float32,
                                     device=device))
    return {
        # projects to [z (din), xBC (din + 2*g*n), dt (h)]
        "in_proj": dense_init(gen, d, 2 * din + 2 * gn + h, dtype, device,
                              lead=lead),
        "conv_w": (conv_w * 0.2).to(dtype),
        "conv_b": torch.zeros(lead + (conv_dim(cfg),), dtype=dtype,
                              device=device),
        "dt_bias": torch.zeros(lead + (h,), dtype=torch.float32,
                               device=device),
        "A_log": a_log.expand(lead + (h,)).contiguous(),
        "D": torch.ones(lead + (h,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones(lead + (din,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, din, d, dtype, device, lead=lead),
    }


def _split_proj(cfg, proj):
    din = cfg.ssm_d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    z = proj[..., :din]
    xbc = proj[..., din:din + din + 2 * gn]
    dt = proj[..., -cfg.ssm_heads:]
    return z, xbc, dt


def _causal_conv(cfg, p, pads):
    """Depthwise causal conv, width W, over ``pads`` (B, W - 1 + S, C):
    S tokens after the W - 1 positions before them (zeros, or a carried
    window): (B, S, C)."""
    w = cfg.ssm_conv_width
    s = pads.shape[1] - (w - 1)
    out = sum(pads[:, i:i + s] * p["conv_w"][i] for i in range(w))
    return F.silu(out + p["conv_b"])


def _gated_norm(cfg, p, y, z, dtype):
    """Gated RMSNorm, mamba2's norm-before-gate, in float32."""
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + cfg.norm_eps)
    return yf.to(dtype) * p["norm_scale"]


def _segsum(a):
    """a: (..., L) -> (..., L, L): out[i, j] = sum(a[j+1..i]) for j <= i,
    -inf above the diagonal (``ssm.py:60-67``)."""
    L = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, *, chunk: int):
    """The reference's training scan (``repro.models.ssm.ssd_chunked``,
    ``ssm.py:70-122``), differentiable, in plain tensor ops: the
    intra-chunk scores, each chunk's outgoing state, the inter-chunk
    recurrence and the inter-chunk output ``y_off``. x: (b, l, h, p); dt:
    (b, l, h) float32 after softplus; A: (h,) negative; B, C: (b, l, g,
    n). Returns y (b, l, h, p) and the final state (b, h, p, n), float32.
    The recurrence runs as a loop over chunks where the reference runs an
    associative scan: the same products, summed in another order."""
    b, l, h, pdim = x.shape
    g, n = B.shape[2], B.shape[3]
    if chunk < 1 or l % chunk:
        raise ValueError(f"ssd_chunked: sequence {l} is not a multiple of "
                         f"chunk {chunk}")
    nc, rep = l // chunk, h // g
    xc = (x.float() * dt[..., None]).reshape(b, nc, chunk, h, pdim)
    ac = (dt * A).float().reshape(b, nc, chunk, h)
    Bh = B.float().reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.float().reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    a_cum = torch.cumsum(ac, dim=2)  # (b, nc, chunk, h)

    # 1) intra-chunk, quadratic within a chunk
    lmat = torch.exp(_segsum(ac.transpose(2, 3)))  # (b, nc, h, chunk, chunk)
    scores = torch.einsum("bzihn,bzjhn->bzhij", Ch, Bh) * lmat
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", scores, xc)

    # 2) each chunk's outgoing state
    decay_out = torch.exp(a_cum[:, :, -1:, :] - a_cum)
    states = torch.einsum("bzlh,bzlhn,bzlhp->bzhpn", decay_out, Bh, xc)

    # 3) the state entering each chunk: S_z = S_{z-1} exp(sum a_z) + states_z
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (b, nc, h)
    state = torch.zeros_like(states[:, 0])
    st_in = []
    for z in range(nc):
        st_in.append(state)
        state = state * chunk_decay[:, z, :, None, None] + states[:, z]
    st_in = torch.stack(st_in, dim=1)  # (b, nc, h, p, n)

    # 4) the inter-chunk output: C_i decay(i) S_in
    y_off = torch.einsum("bzlhn,bzlh,bzhpn->bzlhp", Ch, torch.exp(a_cum),
                         st_in)
    return (y_diag + y_off).reshape(b, l, h, pdim), state


def ssm_forward(cfg, p, x, *, return_cache: bool = False, scan=ssd_scan,
                policy: ShardingPolicy = NO_POLICY):
    """Full-sequence Mamba2 block. x: (B, S, D) -> (B, S, D); with
    ``return_cache`` also the decode cache after the last position.
    ``scan(x, dt, A, B, C, chunk=)`` is the chunked SSD scan: the kernel's
    wrapper by default, :func:`ssd_chunked` on the training path.
    ``policy`` hooks as the reference's (``ssm.py:144, 154``)."""
    b, s, _ = x.shape
    h, pdim, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    din = cfg.ssm_d_inner
    proj = dense(p["in_proj"], x)
    z, xbc_raw, dt = _split_proj(cfg, proj)
    pads = F.pad(xbc_raw, (0, 0, cfg.ssm_conv_width - 1, 0))
    xbc = _causal_conv(cfg, p, pads)
    xin = split_heads(xbc[..., :din], h, pdim)
    bmat = split_heads(xbc[..., din:din + g * n], g, n)
    cmat = split_heads(xbc[..., din + g * n:], g, n)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    xin = policy.act(xin, "ssm_bshp")
    y, final_state = scan(xin, dtv, A, bmat, cmat,
                          chunk=min(cfg.ssm_chunk, s))
    y = y + xin.float() * p["D"][:, None]
    y = y.reshape(b, s, din).to(x.dtype)
    out = dense(p["out_proj"], _gated_norm(cfg, p, y, z, x.dtype), policy,
                "act_bsd")
    if return_cache:
        return out, SSMCache(conv=pads[:, -(cfg.ssm_conv_width - 1):],
                             state=final_state)
    return out


def ssm_forward_packed(cfg, p, x, lens, caches, *, scan=ssd_scan):
    """The Mamba2 block over several sequences' chunks packed on one axis:
    x (1, T, D) holds chunks of ``lens`` tokens in order (T their sum),
    chunk i continuing its sequence from ``caches[i]`` (an
    :class:`SSMCache` of batch 1) or, where that is None, from zeros.
    The projections, the conv and the gated norm run once over all T
    tokens, each chunk's conv reading its own window and no other chunk's
    tokens; the scan runs once a chunk. Returns (1, T, D) and each chunk's
    cache after its last token."""
    w, din = cfg.ssm_conv_width, cfg.ssm_d_inner
    h, pdim, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    z, xbc_raw, dt = _split_proj(cfg, dense(p["in_proj"], x))
    # chunk i as [its window, its tokens]: the conv of the whole run gives
    # chunk i's outputs at [b_i, b_i + len_i), b_i its block's start
    zeros = xbc_raw.new_zeros((1, w - 1, xbc_raw.shape[2]))
    blocks, starts, o, b = [], [], 0, 0
    for s, cache in zip(lens, caches):
        blocks += [zeros if cache is None else cache.conv.to(xbc_raw.dtype),
                   xbc_raw[:, o:o + s]]
        starts.append(b)
        o, b = o + s, b + s + w - 1
    pads = torch.cat(blocks, dim=1)
    conv = _causal_conv(cfg, p, pads)
    xbc = conv if len(lens) == 1 else torch.cat(
        [conv[:, b:b + s] for b, s in zip(starts, lens)], dim=1)
    xin = split_heads(xbc[..., :din], h, pdim)
    bmat = split_heads(xbc[..., din:din + g * n], g, n)
    cmat = split_heads(xbc[..., din + g * n:], g, n)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    ys, new, o = [], [], 0
    for s, b, cache in zip(lens, starts, caches):
        carried = {} if cache is None else {"initial_state": cache.state}
        y, state = scan(xin[:, o:o + s], dtv[:, o:o + s], A,
                        bmat[:, o:o + s], cmat[:, o:o + s],
                        chunk=min(cfg.ssm_chunk, s), **carried)
        ys.append(y)
        new.append(SSMCache(conv=pads[:, b + s:b + s + w - 1], state=state))
        o += s
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = y + xin.float() * p["D"][:, None]
    y = y.reshape(1, o, din).to(x.dtype)
    return dense(p["out_proj"], _gated_norm(cfg, p, y, z, x.dtype)), new


def ssm_decode(cfg, p, x, cache: SSMCache, *,
               policy: ShardingPolicy = NO_POLICY):
    """One-token recurrent update. x: (B, 1, D) -> (B, 1, D), new cache.
    The engine's step (:func:`ssm_step_update`) on copies of the cache's
    window and state, so ``cache`` stays as it was."""
    conv = cache.conv.clone()
    state = cache.state.to(torch.float32, copy=True)
    z, xbc_new, dtv = ssm_step_in(cfg, p, x)
    y = ssm_step_update(cfg, p, xbc_new, dtv, conv, state)
    out = ssm_step_out(cfg, p, y, z, x.dtype, policy)
    return out, SSMCache(conv=conv, state=state)


# -- the engine's decode step over pooled slots --------------------------------

def ssm_step_in(cfg, p, x):
    """A decode step's input projection. x: (n, 1, D) -> (z (n, 1, din),
    the new conv input (n, 1, C), dt (n, H) float32 after softplus)."""
    z, xbc_new, dt = _split_proj(cfg, dense(p["in_proj"], x))
    return z, xbc_new, F.softplus(dt[:, 0].float() + p["dt_bias"])


def ssm_step_update(cfg, p, xbc_new, dtv, conv, state, rows=None):
    """The conv window, the state update and the readout of a decode step,
    in an engine's pools. ``conv`` (n, W-1, C) and ``state`` (n, H, P, N)
    float32 are the layer's pool rows, one per slot; ``rows``: the index
    (m,) of the rows that decode, or None for every row. Those rows'
    windows and states are updated in place; every other row is neither
    read into the result nor written, so its window and state stay as they
    were, bit for bit. Returns y (n, H, P) float32 with the D skip (zeros
    on the other rows) for :func:`ssm_step_out`. The state decays, then
    takes x dt B^T, then is read out by C, in place: each layer's state is
    read and written twice and read once more for the readout."""
    n = xbc_new.shape[0]
    h, pdim, nst, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    din = cfg.ssm_d_inner
    if rows is not None:
        conv_new, xbc_new, dtv = conv[rows], xbc_new[rows], dtv[rows]
        st = state[rows]
    else:
        conv_new, st = conv, state
    win = torch.cat([conv_new, xbc_new], dim=1)  # (m, W, C)
    conv_out = F.silu((win * p["conv_w"][None]).sum(1) + p["conv_b"])
    m = conv_out.shape[0]
    xin = split_heads(conv_out[:, :din], h, pdim).float()
    rep = h // g
    bh = split_heads(conv_out[:, din:din + g * nst], g, nst) \
        .repeat_interleave(rep, dim=1).float()
    ch = split_heads(conv_out[:, din + g * nst:], g, nst) \
        .repeat_interleave(rep, dim=1).float()
    st.mul_(torch.exp(dtv * -torch.exp(p["A_log"]))[..., None, None])
    flat = st.view(m * h, pdim, nst)
    flat.baddbmm_((xin * dtv[..., None]).reshape(m * h, pdim, 1),
                  bh.reshape(m * h, 1, nst))
    y = torch.bmm(flat, ch.reshape(m * h, nst, 1)).view(m, h, pdim)
    y = y + xin * p["D"][:, None]
    if rows is None:
        conv.copy_(win[:, 1:])
        return y
    state.index_copy_(0, rows, st)
    conv.index_copy_(0, rows, win[:, 1:].contiguous())
    return y.new_zeros((n, h, pdim)).index_copy_(0, rows, y)


def ssm_step_out(cfg, p, y, z, dtype, policy: ShardingPolicy = NO_POLICY):
    """The gated norm and output projection of :func:`ssm_step_update`'s
    y (n, H, P): (n, 1, D)."""
    n = y.shape[0]
    y = _gated_norm(cfg, p, y.reshape(n, 1, cfg.ssm_d_inner), z, dtype)
    return dense(p["out_proj"], y, policy, "act_bsd")
