"""Closed-loop traffic: ``sessions`` clients, each sending its next request
as soon as its previous reply is complete (plus ``think_s``).

The k-th request sent in a run is the same for a given seed, whichever
session sends it: its token ids are drawn uniformly from the vocabulary,
and its prompt and output lengths are stratified draws from lognormal
distributions (median, sigma, clipped to [min, max]): every block of
``strata`` consecutive requests holds one length from each of ``strata``
equal-probability bands, in an order drawn from the seed. So every seed
sends the same sizes, in another order, and any stretch of a run sees the
distribution whole.

Session ``i`` sends its first request ``i / sessions`` of ``stagger_s``
after the start, asking for ``(i + 1) / sessions`` of its drawn output
length (at least the minimum), so that neither the first prompts nor the
replies arrive together.

Keys of the traffic file used here: ``sessions``, ``think_s``,
``stagger_s``, ``prompt`` and ``output`` (each ``{"median", "sigma",
"min", "max"}``), ``strata``.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass
class Send:
    session: int
    index: int  # k: the k-th request of the run
    prompt: List[int]
    max_new_tokens: int
    at: float  # when it is due (the client's clock)


def lognormal_quantile(spec, u: float) -> int:
    x = spec["median"] * math.exp(spec["sigma"] * NormalDist().inv_cdf(u))
    return int(min(spec["max"], max(spec["min"], round(x))))


class Loop:
    def __init__(self, spec, seed: int, vocab: int):
        self.spec = spec
        self.vocab = vocab
        self.sessions = int(spec["sessions"])
        self.think = float(spec.get("think_s", 0.0))
        self.strata = int(spec.get("strata", 32))
        self.rng = np.random.default_rng([seed % (1 << 63), 0xC105ED])
        self.sent = 0
        self._bands: List[tuple] = []

    def _lengths(self, k: int):
        """(prompt length, output length) of the k-th request."""
        while len(self._bands) <= k:
            n = self.strata
            bp = self.rng.permutation(n)
            bo = self.rng.permutation(n)
            jp = self.rng.random(n)
            jo = self.rng.random(n)
            for i in range(n):
                self._bands.append(((bp[i] + jp[i]) / n, (bo[i] + jo[i]) / n))
        up, uo = self._bands[k]
        return (lognormal_quantile(self.spec["prompt"], up),
                lognormal_quantile(self.spec["output"], uo))

    def _send(self, session: int, at: float, first: bool) -> Send:
        k = self.sent
        self.sent += 1
        plen, olen = self._lengths(k)
        if first:
            olen = max(self.spec["output"]["min"],
                       round(olen * (session + 1) / self.sessions))
        prompt = self.rng.integers(0, self.vocab, plen).tolist()
        return Send(session, k, prompt, int(olen), at)

    def start(self, now: float) -> List[Send]:
        """One request per session, session ``i`` due ``i / sessions`` of
        ``stagger_s`` from now."""
        step = float(self.spec.get("stagger_s", 0.0)) / self.sessions
        return [self._send(s, now + s * step, True)
                for s in range(self.sessions)]

    def on_reply(self, session: int, now: float) -> List[Send]:
        """The session's reply is complete at ``now``: its next request."""
        return [self._send(session, now + self.think, False)]
