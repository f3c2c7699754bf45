"""Mixture-of-Experts with capacity-based dispatch, one for one with
``repro.models.moe``: GShard's grouped dispatch, and the policy's
``moe_apply`` hook (the mesh's expert-parallel form,
``repro_torch.launch.sharding.MeshPolicy.moe_apply``).

Top-k routing with a static per-expert capacity: each (token, choice) takes
the next place of its expert, in token-major, choice-minor order, and a
place at or past the capacity is dropped (the token falls through to the
residual). Expert weights are stacked ``(E, d, ff)``; the expert products
are batched matrix products, as the reference computes them in XLA
einsums outside any kernel. Shared experts are a plain gated MLP of width
``ArchConfig.shared_width`` (``num_shared_experts * moe_d_ff``, or the
config's own ``shared_d_ff``) applied to every token.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import NO_POLICY, ShardingPolicy, \
    dense_init, mlp, mlp_init, normal_init


def moe_init(cfg, gen, dtype, device, *, lead=()):
    """The reference's distributions (``moe.py:21-34``): a float32 router
    (d, E), ``gate`` / ``up`` (E, d, ff) normal * 1/sqrt(d), ``down``
    (E, ff, d) normal * 1/sqrt(ff), and the shared gated MLP."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, d, e, torch.float32, device, lead=lead),
        "gate": normal_init(gen, lead + (e, d, ff), 1.0 / math.sqrt(d),
                            dtype, device),
        "up": normal_init(gen, lead + (e, d, ff), 1.0 / math.sqrt(d),
                          dtype, device),
        "down": normal_init(gen, lead + (e, ff, d), 1.0 / math.sqrt(ff),
                            dtype, device),
    }
    if cfg.shared_width:
        p["shared"] = mlp_init(gen, d, cfg.shared_width, dtype, device,
                               gated=True, lead=lead)
    return p


def capacity(cfg, num_tokens: int) -> int:
    """Places per expert for ``num_tokens`` tokens: top_k x factor of an
    even share, a multiple of 8, at least 8."""
    c = int(num_tokens * cfg.moe_top_k * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, (c + 7) // 8 * 8)


def moe_forward(cfg, p, x, *, policy: ShardingPolicy = NO_POLICY,
                return_aux: bool = False,
                capacity_tokens: Optional[int] = None,
                fit_capacity: bool = False):
    """x: (B, S, D) -> (B, S, D) [+ the Switch-style load-balance loss].

    GShard's grouped dispatch (``moe.py:55-112`` of the reference): the
    tokens split into ``policy.moe_groups`` groups (one per data shard on
    a mesh; one without a policy), and each group fills its own capacity
    of every expert, so drops depend on the groups. A policy's
    ``moe_apply`` (the mesh's expert-parallel form) replaces the dispatch
    where it returns a result.

    ``capacity_tokens`` sizes the experts' capacity in place of a group's
    token count (the serving engine passes the reference's padded chunk
    length; the tokens it would pad come after every real one, so only
    the capacity differs). ``fit_capacity`` then runs the experts at the
    least power of two (at least 8) that holds the fullest expert's
    places, where that is below the capacity: the same (token, choice)s
    are kept, over fewer rows, for one read of the places on the host.
    """
    out = policy.moe_apply(cfg, p, x, return_aux)
    if out is not None:
        return out
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    t = b * s
    g = policy.moe_groups if t % policy.moe_groups == 0 else 1
    tg = t // g
    cap = capacity(cfg, tg if capacity_tokens is None else capacity_tokens)
    xt = x.reshape(g, tg, d)

    probs = torch.softmax(xt.float() @ p["router"]["w"], dim=-1)  # (G,Tg,E)
    # lax.top_k: descending, the lower index first among equal values; a
    # stable descending sort promises that order, torch.topk does not
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    # each (token, choice)'s place in its expert within its group: an
    # exclusive cumsum over the token-major, choice-minor order
    onehot = F.one_hot(topi.reshape(g, tg * k), e)  # (G, Tg*k, E)
    pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1).view(g, tg, k)
    if fit_capacity:
        # the fullest expert's places, read on the host: the smallest
        # power of two (at least 8) holding them, where that is below the
        # static capacity, keeps the same (token, choice)s in fewer rows
        need = int(pos.max()) + 1
        cap = min(cap, max(8, 1 << (need - 1).bit_length()))
    keep = pos < cap

    # dispatch (G, E, cap, D): dropped places land in a spare row past cap
    gidx = torch.arange(g, device=x.device)[:, None, None].expand(g, tg, k)
    disp = x.new_zeros((g, e, cap + 1, d))
    disp[gidx, topi, torch.where(keep, pos, cap)] = \
        xt[:, :, None, :].expand(g, tg, k, d)
    disp = policy.act(disp[:, :, :cap], "expert_gecd")

    # expert MLPs: gated SwiGLU, batched over the experts (E, G cap, D)
    de = disp[0] if g == 1 else \
        disp.transpose(0, 1).reshape(e, g * cap, d)
    h = F.silu(torch.bmm(de, p["gate"])) * torch.bmm(de, p["up"])
    h = policy.act(h.view(e, g, cap, -1).transpose(0, 1), "expert_gecf")
    h = h[0] if g == 1 else h.transpose(0, 1).reshape(e, g * cap, -1)
    out = torch.bmm(h, p["down"]).view(e, g, cap, d).transpose(0, 1)
    out = policy.act(out, "expert_gecd")  # (G, E, cap, D)

    # combine: each (token, choice)'s place back, weighted in the model
    # type (the reference casts topv * keep before the product)
    gathered = out[gidx, topi, torch.where(keep, pos, 0)]  # (G, Tg, k, D)
    w = (topv * keep).to(x.dtype)
    y = (gathered * w[..., None]).sum(2).view(b, s, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x, policy)

    if return_aux:
        frac_tokens = F.one_hot(topi[..., 0], e).float().mean((0, 1))
        aux = e * (frac_tokens * probs.mean((0, 1))).sum()
        return y, aux
    return y
