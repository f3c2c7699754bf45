"""Synthetic data pipeline: deterministic corpus stream + packing + sharding
(a copy of ``repro.training.data``, which is numpy only; its batches are
the reference's byte for byte).

No real corpora ship with the repo; we generate a *structured* synthetic
language (Zipf-distributed unigrams + a Markov backbone so the model has
something learnable — loss decreases measurably within a few hundred steps,
which the quickstart example asserts) and pack documents into fixed-length
training sequences with EOS separators, exactly like a production loader.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos: int = 1
    zipf_a: float = 1.3
    markov_order: int = 1
    doc_len_mean: float = 180.0


class SyntheticCorpus:
    """Deterministic, seekable synthetic token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipf marginals over the vocab (ids 2.. ; 0=pad, 1=eos)
        ranks = np.arange(2, v)
        p = 1.0 / ranks.astype(np.float64) ** cfg.zipf_a
        self.marginal = p / p.sum()
        # sparse Markov backbone: each token has ~8 likely successors
        self.n_succ = 8
        self.succ = rng.integers(2, v, size=(v, self.n_succ))

    def documents(self, seed: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed, seed))
        v = self.cfg.vocab_size
        while True:
            n = max(8, int(rng.exponential(self.cfg.doc_len_mean)))
            toks = np.empty(n, np.int64)
            toks[0] = rng.choice(v - 2, p=self.marginal) + 2
            for i in range(1, n):
                if rng.random() < 0.75:  # follow the backbone
                    toks[i] = self.succ[toks[i - 1], rng.integers(self.n_succ)]
                else:
                    toks[i] = rng.choice(v - 2, p=self.marginal) + 2
            yield toks

    def batches(self, *, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Packed (tokens, labels) batches; labels == tokens (shift happens
        in the loss); EOS separates packed documents."""
        cfg = self.cfg
        docs = self.documents(seed=start_step)
        buf = np.empty(0, np.int64)
        step = start_step
        while True:
            need = cfg.global_batch * cfg.seq_len
            while len(buf) < need:
                d = next(docs)
                buf = np.concatenate([buf, d, [cfg.eos]])
            batch = buf[:need].reshape(cfg.global_batch, cfg.seq_len)
            buf = buf[need:]
            yield {"tokens": batch.astype(np.int32),
                   "labels": batch.astype(np.int32)}
            step += 1
