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


def _causal_conv(cfg, p, xbc):
    """Depthwise causal conv, width W: (B, S, C) -> (B, S, C)."""
    w, s = cfg.ssm_conv_width, xbc.shape[1]
    pads = F.pad(xbc, (0, 0, w - 1, 0))
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
    xbc = _causal_conv(cfg, p, xbc_raw)
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
        w = cfg.ssm_conv_width
        tail = F.pad(xbc_raw, (0, 0, max(w - 1 - s, 0), 0))[:, -(w - 1):]
        return out, SSMCache(conv=tail, state=final_state)
    return out


def ssm_decode(cfg, p, x, cache: SSMCache, *,
               policy: ShardingPolicy = NO_POLICY):
    """One-token recurrent update. x: (B, 1, D) -> (B, 1, D), new cache."""
    b = x.shape[0]
    h, pdim, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    din = cfg.ssm_d_inner
    proj = dense(p["in_proj"], x)  # (B, 1, *)
    z, xbc_new, dt = _split_proj(cfg, proj)

    # rolling conv buffer: window = [cache.conv, xbc_new]
    win = torch.cat([cache.conv, xbc_new], dim=1)  # (B, W, C)
    conv_out = F.silu((win * p["conv_w"][None]).sum(1) + p["conv_b"])

    xin = split_heads(conv_out[:, :din], h, pdim)
    rep = h // g
    bh = split_heads(conv_out[:, din:din + g * n], g, n) \
        .repeat_interleave(rep, dim=1)
    ch = split_heads(conv_out[:, din + g * n:], g, n) \
        .repeat_interleave(rep, dim=1)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])

    decay = torch.exp(dtv * A)
    state = cache.state * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xin.float() * dtv[..., None], bh.float())
    y = torch.einsum("bhpn,bhn->bhp", state, ch.float())
    y = y + xin.float() * p["D"][:, None]
    y = _gated_norm(cfg, p, y.reshape(b, 1, din), z, x.dtype)
    out = dense(p["out_proj"], y, policy, "act_bsd")
    return out, SSMCache(conv=win[:, 1:], state=state)
