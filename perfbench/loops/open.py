"""Open-loop traffic: requests arrive as a Poisson process at a fixed rate,
each from a session of its own that sends nothing else, whatever the
replies do.

:meth:`Loop.start` schedules every arrival from its ``now`` to ``now +
horizon_s`` at once (the harness calls it once, before the warm-up), so
the horizon has to cover the warm-up and the longest window. The gaps
between arrivals are independent exponential draws with mean ``1 /
rate_rps``, so a window's count of arrivals is Poisson, bursts and lulls
included. The k-th request's prompt and output lengths are lognormal
(median, sigma, clipped to [min, max]) and stratified, as the lengths in
``loops/closed.py`` are: every block of ``strata`` consecutive requests
holds one length of each kind from each of ``strata`` equal-probability
bands, in an order drawn from the seed. Token ids are drawn uniformly from
the vocabulary. The same seed gives the same schedule.

Keys of the traffic file used here: ``rate_rps``, ``horizon_s``,
``prompt`` and ``output`` (each ``{"median", "sigma", "min", "max"}``),
``strata``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from perfbench.loops.closed import Send, lognormal_quantile


class Loop:
    def __init__(self, spec, seed: int, vocab: int):
        self.spec = spec
        self.vocab = vocab
        self.rate = float(spec["rate_rps"])
        self.horizon = float(spec["horizon_s"])
        self.strata = int(spec.get("strata", 32))
        self.rng = np.random.default_rng([seed % (1 << 63), 0x0BE7])

    def _block(self):
        """(prompt length, output length) of ``strata`` requests, each kind
        one draw from each band."""
        k = self.strata
        u = [(self.rng.permutation(k) + self.rng.random(k)) / k
             for _ in range(2)]
        return [(lognormal_quantile(self.spec["prompt"], u[0][i]),
                 lognormal_quantile(self.spec["output"], u[1][i]))
                for i in range(k)]

    def start(self, now: float) -> List[Send]:
        """Every arrival in ``[now, now + horizon_s)``."""
        sends, t = [], now
        while True:
            for plen, olen in self._block():
                t += self.rng.exponential(1.0 / self.rate)
                if t >= now + self.horizon:
                    return sends
                prompt = self.rng.integers(0, self.vocab, plen).tolist()
                sends.append(Send(len(sends), len(sends), prompt, int(olen),
                                  t))

    def on_reply(self, session: int, now: float) -> List[Send]:
        """An open loop's sessions send one request each."""
        return []
