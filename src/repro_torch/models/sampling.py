"""Token sampling for the serving engine (``repro.models.sampling``).

All slots are sampled in one call with per-slot parameters. Greedy rows and
the logprobs match the reference. Sampled rows draw from a counter-based
generator keyed by ``(seed, step, vocab index)``: a request's stream is
deterministic per ``(seed, step)`` whatever batch or slot it runs in and on
either device, but its bits are not JAX's threefry bits, so sampled tokens
differ from the reference's. The scalar-parameter :func:`sample` draws
from an explicit ``torch.Generator``: the reference's distribution, not its
bits.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_logits(logits, top_k, top_p):
    """Per-row top-k / nucleus filtering.

    logits: (n, V); top_k: (n,) int, 0 = disabled; top_p: (n,) float in
    (0, 1], 1 = disabled. Returns float32 logits with filtered entries at
    ``-inf``. The nucleus is the smallest set of highest-probability tokens
    whose mass reaches ``top_p`` (the argmax always survives).
    """
    n, v = logits.shape
    logits = logits.float()
    order = torch.argsort(-logits, dim=-1, stable=True)  # descending
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(v, device=logits.device)
                   .expand(n, v))
    k_eff = torch.where(top_k > 0, top_k.long(), torch.full_like(
        top_k.long(), v))
    keep_k = ranks < k_eff[:, None]
    sorted_logits = torch.gather(logits, 1, order)
    probs_sorted = torch.softmax(sorted_logits, dim=-1)
    # exclusive cumulative mass: keep a token iff the mass strictly above
    # it is still short of top_p. top_p = 1 keeps every token even where a
    # float32 cumsum rounds up to 1 before the tail
    cum_excl = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    keep_sorted = (cum_excl < top_p[:, None]) | (top_p[:, None] >= 1.0)
    keep_p = torch.gather(keep_sorted, 1, ranks)
    return torch.where(keep_k & keep_p, logits,
                       torch.full_like(logits, float("-inf")))


def _hash32(x):
    """PCG-style 32-bit integer hash on int64 tensors holding values in
    [0, 2**32); every product stays below 2**63."""
    x = (x * 747796405 + 2891336453) & _MASK32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _MASK32
    return (x >> 22) ^ x


def uniform_noise(seeds, steps, v: int):
    """(n, v) float32 uniforms in (0, 1), a pure function of each row's
    ``(seed, step)`` and the vocab index: the counter-based stream."""
    dev = seeds.device
    row = _hash32(_hash32(seeds.long() & _MASK32) ^ (steps.long() & _MASK32))
    col = torch.arange(v, device=dev, dtype=torch.int64)
    bits = _hash32(_hash32(row[:, None] ^ col[None, :]) ^ 0x9E3779B9)
    # 23 bits keep the largest value, 1 - 2**-24, below 1 in float32
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def sample_batch(logits, seeds, steps, temperature, top_k, top_p):
    """One fused sampling step over all slots.

    logits: (n, V); seeds / steps: (n,) per-request stream ids;
    temperature / top_k / top_p: (n,). Rows with ``temperature <= 0`` are
    greedy over the raw logits. Temperature scales before the top-k/top-p
    filters. Sampled rows take the Gumbel-max of the filtered logits, so
    the token always lies in the kept set. Returns ``(tokens (n,) int32,
    logprobs (n,) float32)``: log p(token) under the raw distribution.
    """
    logits = logits.float()
    greedy_tok = greedy(logits)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))[:, None]
    scaled = filter_logits(logits / safe_t, top_k, top_p)
    u = uniform_noise(seeds, steps, logits.shape[1])
    drawn = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    tokens = torch.where(temperature > 0, drawn.to(torch.int32), greedy_tok)
    logprobs = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                            tokens.long()[:, None])[:, 0]
    return tokens, logprobs


def sample(logits, generator, *, temperature: float = 1.0, top_k: int = 0):
    """Scalar-parameter sampling (the reference's legacy path; the engine
    uses :func:`sample_batch`). logits: (B, V); ``generator`` is a
    ``torch.Generator`` on the logits' device, in place of the reference's
    PRNG key. ``temperature <= 0`` is greedy. Otherwise the scaled logits
    below the k-th largest are dropped (ties at the k-th value kept) and
    one token a row is drawn from the softmax of the rest: the reference's
    distribution, drawn with torch's generator rather than threefry."""
    if temperature <= 0:
        return greedy(logits)
    logits = logits.float() / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0].to(torch.int32)
