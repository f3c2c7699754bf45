"""Decoder stack for the dense GQA plan (``repro.models.transformer``).

A model is a sequence of **segments**: runs of identical layers whose
parameters are stacked along a leading layer axis, exactly as the
reference stores them (``transformer.py:319``). The reference scans over
that axis; here a Python loop indexes it. This slice carries the plain
GQA plan, global or sliding window (danube: ``[24 x swa-dense]``);
``Model.forward`` is the teacher-forced oracle of the engine tests and of
``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import embed, rms_norm, unembed


@dataclasses.dataclass(frozen=True)
class Segment:
    n: int
    mixer: str  # "gqa" | "mla" | "ssm" | "hybrid"
    mlp_kind: str  # "dense" | "moe" | "none"
    attn_kind: str  # "global" | "swa" | "none"


def stack_plan(cfg: ArchConfig) -> List[Segment]:
    """The reference's plan for a dense decoder (``transformer.py:51``);
    the other families come with their slices of the port."""
    if cfg.family == "ssm" or cfg.is_hybrid or cfg.is_moe or cfg.is_encdec \
            or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.arch_id}: only the dense GQA plan is ported so far")
    attn_kind = "swa" if cfg.sliding_window else "global"
    return [Segment(cfg.num_layers, "gqa", "dense", attn_kind)]


def layer_params(p_seg, i: int):
    """Parameters of layer ``i`` of a stacked segment (views, no copy)."""
    if isinstance(p_seg, dict):
        return {k: layer_params(v, i) for k, v in p_seg.items()}
    return p_seg[i]


def seg_window(cfg: ArchConfig, seg: Segment):
    return cfg.sliding_window if seg.attn_kind == "swa" else None


class Model:
    """Parameters are passed in, as in the reference: a nested dict from
    :func:`repro_torch.bridge.init_params` or the bridge."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.plan = stack_plan(cfg)

    def layers(self, params):
        """Yield ``(seg, layer_index, layer_params)`` over the whole stack."""
        li = 0
        for seg, p_seg in zip(self.plan, params["segments"]):
            for j in range(seg.n):
                # a one-layer segment is stored without the stacked axis
                yield seg, li, p_seg if seg.n == 1 else layer_params(p_seg, j)
                li += 1

    @torch.no_grad()
    def forward(self, params, tokens):
        """Teacher-forced logits (B, S, V) and the MoE aux loss (zero for a
        dense plan), as the reference returns them."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for seg, _, p in self.layers(params):
            window = seg_window(cfg, seg)

            def attend(q, k, v, window=window):
                return attn.blockwise_attention(q, k, v, causal=True,
                                                window=window)

            x = attn.gqa_layer(cfg, p, x, positions, attend)
        x = rms_norm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg.vocab_size,
                         fp32=cfg.logits_fp32)
        return logits, torch.zeros((), device=logits.device)
