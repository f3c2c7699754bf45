"""Roofline terms of a dry-run on the H100 (the port of
``repro.roofline.analysis``).

Terms, per GPU (the data sheet's H100 SXM5 at 700 W):

  compute    = FLOPs / 989e12             [bf16 dense tensor-core peak]
  memory     = bytes / 3.35e12            [HBM3]
  collective = collective bytes / 50e9    [one 400 Gb/s InfiniBand port]

Both axes of the 16 x 16 mesh leave an 8-GPU NVLink domain (NVLink 4:
450 GB/s each way a GPU, the in-node figure), so the link term is the
network port's, not NVLink's.

The counts come from the dry-run (``repro_torch.launch.dryrun``), which
runs the program SPMD on the fake process group and counts what *one
rank* runs on its local shards, as the reference's ``cost_analysis`` of
the partitioned module counts per device:

* FLOPs: the matmul-class ops (``torch.utils.flop_counter``'s formulas)
  on local shapes; elementwise work is not counted.
* bytes: each local op's input and output bytes, op by op as eager
  PyTorch runs them (views free). This is an upper bound beside XLA's
  count, which fuses elementwise chains and reads their operands once.
* collective bytes: the output bytes of every functional collective the
  rank issues, by kind, as the reference sums the output shapes of every
  collective op of the partitioned HLO (``analysis.py:48-61``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12  # bf16 / GPU, dense
HBM_BW = 3.35e12     # bytes/s / GPU
LINK_BW = 50e9       # bytes/s / GPU: one 400 Gb/s InfiniBand port
NVLINK_BW = 450e9    # bytes/s / GPU each way, inside an 8-GPU node only
HBM_BYTES = 80e9     # the card's memory (the data sheet's 80 GB)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class Roofline:
    flops: float                 # per GPU
    bytes_accessed: float        # per GPU
    coll_bytes: float            # per GPU, summed over kinds
    coll_breakdown: Dict[str, int]
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "chips": self.chips,
        }


def analyze(counts, chips: int) -> Roofline:
    """The roofline of one rank's counts (``dryrun.Counter``: ``flops``,
    ``bytes``, ``collectives`` {kind: bytes})."""
    cb = {k: int(counts.collectives.get(k, 0)) for k in COLLECTIVES}
    return Roofline(flops=float(counts.flops),
                    bytes_accessed=float(counts.bytes),
                    coll_bytes=float(sum(cb.values())), coll_breakdown=cb,
                    chips=chips)


def extrapolate(r2: Roofline, r4: Roofline, l2: int, l4: int,
                l_full: int) -> Roofline:
    """Linear layer-count extrapolation between two capped runs
    (``analysis.py:107-133``): exact for per-layer terms, since the layers
    of a segment are alike; the intercept holds the embedding, the loss
    and the optimizer's fixed costs."""
    if l4 == l2:
        return r4

    def ext(v2, v4):
        slope = (v4 - v2) / (l4 - l2)
        return v2 + slope * (l_full - l2)

    cb = {k: max(0.0, ext(r2.coll_breakdown.get(k, 0),
                          r4.coll_breakdown.get(k, 0)))
          for k in set(r2.coll_breakdown) | set(r4.coll_breakdown)}
    return Roofline(
        flops=max(0.0, ext(r2.flops, r4.flops)),
        bytes_accessed=max(0.0, ext(r2.bytes_accessed, r4.bytes_accessed)),
        coll_bytes=float(sum(cb.values())),
        coll_breakdown={k: int(v) for k, v in cb.items()},
        chips=r4.chips,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (prefill, decode) over the
    *matmul* parameters N (embeddings excluded: a lookup is a gather; the
    unembedding is added back), N_active for MoE; an encoder-decoder's
    encoder parameters see seq / 4 tokens (``analysis.py:136-170``)."""
    from repro_torch.models.layers import pad_vocab
    n = cfg.n_active_params() if cfg.is_moe else cfg.n_params()
    embed = pad_vocab(cfg.vocab_size) * cfg.d_model
    n_matmul = n - embed * (1 if cfg.tie_embeddings else 2)

    factor = 6 if shape.kind == "train" else 2
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch  # one new token per sequence

    if cfg.is_encdec:
        enc_frac = cfg.encoder_layers / (cfg.encoder_layers + cfg.num_layers)
        enc_tokens = (shape.global_batch * (shape.seq_len // 4)
                      if shape.kind != "decode" else 0)
        f = factor * n_matmul * (
            (1 - enc_frac) * tokens + enc_frac * enc_tokens) / 1.0
    else:
        f = factor * n_matmul * tokens
    # the unembedding (a vocab-parallel matmul is real work); prefill
    # unembeds the last position only
    f += factor * embed * tokens if shape.kind == "train" else \
        2 * embed * shape.global_batch
    return f
