"""Mixture-of-Experts with capacity-based dispatch, one for one with
``repro.models.moe`` on one group (the reference's ``NO_POLICY``; its mesh
``moe_apply`` branch comes with the sharding slice of the port).

Top-k routing with a static per-expert capacity: each (token, choice) takes
the next place of its expert, in token-major, choice-minor order, and a
place at or past the capacity is dropped (the token falls through to the
residual). Expert weights are stacked ``(E, d, ff)``; the expert products
are batched matrix products, as the reference computes them in XLA
einsums outside any kernel. Shared experts (``num_shared_experts``) are a
plain gated MLP of width ``num_shared_experts * moe_d_ff`` applied to every
token.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp, mlp_init, \
    normal_init


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
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.num_shared_experts * ff, dtype,
                               device, gated=True, lead=lead)
    return p


def capacity(cfg, num_tokens: int) -> int:
    """Places per expert for ``num_tokens`` tokens: top_k x factor of an
    even share, a multiple of 8, at least 8."""
    c = int(num_tokens * cfg.moe_top_k * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, (c + 7) // 8 * 8)


def moe_forward(cfg, p, x, *, return_aux: bool = False,
                capacity_tokens: Optional[int] = None):
    """x: (B, S, D) -> (B, S, D) [+ the Switch-style load-balance loss].

    ``capacity_tokens`` sizes the experts' capacity in place of B * S (the
    serving engine passes the reference's padded chunk length; the tokens
    it would pad come after every real one, so only the capacity differs).
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    t = b * s
    cap = capacity(cfg, t if capacity_tokens is None else capacity_tokens)
    xt = x.reshape(t, d)

    probs = torch.softmax(xt.float() @ p["router"]["w"], dim=-1)  # (T, E)
    # lax.top_k: descending, the lower index first among equal values; a
    # stable descending sort promises that order, torch.topk does not
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    # each (token, choice)'s place in its expert: an exclusive cumsum over
    # the token-major, choice-minor order
    onehot = F.one_hot(topi.reshape(t * k), e)  # (T*k, E)
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1).view(t, k)
    keep = pos < cap

    # dispatch (E, cap, D): dropped places land in a spare row past cap
    disp = x.new_zeros((e, cap + 1, d))
    disp[topi, torch.where(keep, pos, cap)] = \
        xt[:, None, :].expand(t, k, d)
    disp = disp[:, :cap]

    # expert MLPs: gated SwiGLU, batched over the experts
    h = F.silu(torch.bmm(disp, p["gate"])) * torch.bmm(disp, p["up"])
    out = torch.bmm(h, p["down"])  # (E, cap, D)

    # combine: each (token, choice)'s place back, weighted in the model
    # type (the reference casts topv * keep before the product)
    gathered = out[topi, torch.where(keep, pos, 0)]  # (T, k, D)
    w = (topv * keep).to(x.dtype)
    y = (gathered * w[..., None]).sum(1).view(b, s, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x)

    if return_aux:
        frac_tokens = F.one_hot(topi[:, 0], e).float().mean(0)
        aux = e * (frac_tokens * probs.mean(0)).sum()
        return y, aux
    return y
