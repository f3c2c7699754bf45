"""Whether what the timed path served is correct.

Greedy tokens only. Once the window has closed and the program's state is
freed, a sample of the requests the program finished, drawn from the seed
and always holding the longest reply, is run through the configuration's
plain float32 reference once, over each prompt followed by the tokens the
program served. At every served token the reference's logits give a gap:
its best logit minus the logit of the served token (0 where the program
served the reference's own best). The numbers compared, each with its
limit, are those the configuration's ``check.limits`` names among
:func:`readings` (PERF.md, section 2, says which and why).

The control puts the reference, computed on float8 operands
(:class:`perfbench.reference.common.Quant`), in the program's place: at
the same positions of the same sequences its gap is that of the token it
ranks first.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import torch

from perfbench.reference.common import Quant


def sample(done: Sequence, seed: int, target_tokens: int) -> List:
    """Finished requests (objects with ``rid``, ``prompt``, ``out``): the
    one with the longest reply, then others in an order drawn from
    ``seed``, until ``target_tokens`` served tokens are in."""
    if not done:
        return []
    pool = sorted(done, key=lambda r: r.rid)
    longest = max(pool, key=lambda r: (len(r.out), -r.rid))
    rest = [r for r in pool if r is not longest]
    random.Random(seed % (1 << 63)).shuffle(rest)
    out, n = [longest], len(longest.out)
    for r in rest:
        if n >= target_tokens:
            break
        out.append(r)
        n += len(r.out)
    return out


def _seqs(reqs):
    """Each prompt with all but the last served token (the last one's
    logits come from the position before it), and the first position
    whose logits are compared."""
    return ([list(r.prompt) + list(r.out[:-1]) for r in reqs],
            [len(r.prompt) - 1 for r in reqs])


def _block(reqs, max_tokens: int):
    """The sample in blocks of requests of at most ``max_tokens`` tokens
    (one request alone may exceed it)."""
    blk, n = [], 0
    for r in reqs:
        size = len(r.prompt) + len(r.out)
        if blk and n + size > max_tokens:
            yield blk
            blk, n = [], 0
        blk.append(r)
        n += size
    if blk:
        yield blk


def gaps(ref_mod, conf, weights, reqs, *, control: bool = False,
         block_tokens: int = 8192) -> dict:
    """Per served token, in order: its gap (``served``), the reference's
    margin between its best and second-best logit (``margin``) and, with
    ``control``, the gap of the control's first-ranked token
    (``control``)."""
    out = {"served": [], "margin": []}
    if control:
        out["control"] = []
    for blk in _block(reqs, block_tokens):
        seqs, firsts = _seqs(blk)
        ref = ref_mod.logits(conf, weights, seqs, firsts)
        served = torch.tensor([t for r in blk for t in r.out],
                              device=ref.device)
        top2 = ref.topk(2, dim=-1).values
        best = top2[:, 0]
        out["served"] += (best - ref.gather(1, served[:, None])[:, 0]).tolist()
        out["margin"] += (best - top2[:, 1]).tolist()
        if control:
            low = ref_mod.logits(conf, weights, seqs, firsts, quant=Quant())
            pick = low.argmax(dim=-1)
            out["control"] += (best - ref.gather(1, pick[:, None])[:, 0]) \
                .tolist()
            del low
        del ref
    return out


def readings(gap: List[float]) -> dict:
    """The numbers a configuration's ``check.limits`` may name, over the
    compared tokens' gaps: the widest (``max_logit_gap``), the mean
    (``mean_logit_gap``) and the mean of the squares
    (``msq_logit_gap``)."""
    if not gap:
        return {}
    return {"max_logit_gap": max(gap),
            "mean_logit_gap": sum(gap) / len(gap),
            "msq_logit_gap": sum(g * g for g in gap) / len(gap)}


def verdict(numbers: dict) -> bool:
    """Every number within its limit."""
    return all(v["value"] <= v["limit"] for v in numbers.values())


def stderr_lines(numbers: dict) -> List[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in numbers.items()]


def served_ok(reqs, vocab: int) -> Optional[str]:
    """A reason the served tokens cannot be judged (an id outside the
    vocabulary), or None."""
    for r in reqs:
        if any(not 0 <= t < vocab for t in r.out):
            return f"request {r.rid} served a token outside the vocabulary"
    return None
