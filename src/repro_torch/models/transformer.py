"""Decoder stack (``repro.models.transformer``) for the plans ported so
far: dense GQA, global or sliding window (danube: ``[24 x swa-dense]``),
MoE on GQA (llama4-scout: ``[48 x gqa-moe]``), MLA + MoE (deepseek-v2:
``[1 x mla-dense, 59 x mla-moe]``; a MoE plan starts with its
``first_k_dense`` dense layers), and the attention-free SSM plan (mamba2:
``[48 x ssm]``).

A model is a sequence of **segments**: runs of identical layers whose
parameters are stacked along a leading layer axis, exactly as the
reference stores them (``transformer.py:319``). The reference scans over
that axis; here a Python loop indexes it. ``Model.forward`` is the
teacher-forced oracle of the engine tests and of ``chip_smoke.py``; an MLA
layer there decompresses the latent and runs standard attention
(``mla_forward``), where the engine attends over the latent.
``Model.prefill`` / ``Model.decode_step`` serve the SSM plan, whose decode
cache is a constant-size state (the paged engine serves GQA and MLA); a
segment's cache is an :class:`SSMCache` whose tensors carry the segment's
stacked layer axis, as the reference's scan stacks them.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import embed, mlp, rms_norm, unembed
from repro_torch.models.moe import moe_forward


@dataclasses.dataclass(frozen=True)
class Segment:
    n: int
    mixer: str  # "gqa" | "mla" | "ssm" | "hybrid"
    mlp_kind: str  # "dense" | "moe" | "none"
    attn_kind: str  # "global" | "swa" | "none"


def stack_plan(cfg: ArchConfig) -> List[Segment]:
    """The reference's plan (``transformer.py:51``) for a GQA or MLA
    decoder, dense or MoE, or an SSM decoder; the other families come with
    their slices of the port."""
    if cfg.family == "ssm":
        if cfg.d_ff:
            raise NotImplementedError(
                f"{cfg.arch_id}: an SSM plan with an MLP is not ported yet")
        return [Segment(cfg.num_layers, "ssm", "none", "none")]
    if cfg.is_hybrid or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.arch_id}: only the GQA and MLA (dense or MoE) and SSM "
            "plans are ported so far")
    mixer = "mla" if cfg.attention == "mla" else "gqa"
    attn_kind = "swa" if cfg.sliding_window else "global"
    if cfg.is_moe:
        segs = []
        if cfg.first_k_dense:
            segs.append(Segment(cfg.first_k_dense, mixer, "dense",
                                attn_kind))
        segs.append(Segment(cfg.num_layers - cfg.first_k_dense, mixer, "moe",
                            attn_kind))
        return segs
    return [Segment(cfg.num_layers, mixer, "dense", attn_kind)]


def layer_params(p_seg, i: int):
    """Parameters of layer ``i`` of a stacked segment (views, no copy)."""
    if isinstance(p_seg, dict):
        return {k: layer_params(v, i) for k, v in p_seg.items()}
    return p_seg[i]


def seg_window(cfg: ArchConfig, seg: Segment):
    return cfg.sliding_window if seg.attn_kind == "swa" else None


def ssm_layer(cfg, p, x, *, return_cache: bool = False):
    """One SSM layer (pre-norm residual Mamba2 block, no MLP)."""
    out = ssm_mod.ssm_forward(cfg, p["ssm"], rms_norm(p["ln1"], x,
                                                      cfg.norm_eps),
                              return_cache=return_cache)
    if return_cache:
        out, cache = out
        return x + out, cache
    return x + out


def mla_forward_layer(cfg, p, x, positions, mlp_fn=None):
    """One full-sequence MLA layer: pre-norm residual ``mla_forward`` (the
    decompressed form), then the pre-norm residual MLP, as the reference's
    ``_layer_forward`` runs it (``transformer.py:139-141, 169-176``)."""
    x = x + attn.mla_forward(cfg, p["attn"],
                             rms_norm(p["ln1"], x, cfg.norm_eps), positions)
    h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
    return x + (mlp(p["mlp"], h2) if mlp_fn is None else mlp_fn(p["mlp"], h2))


def _stack_caches(caches):
    return ssm_mod.SSMCache(conv=torch.stack([c.conv for c in caches]),
                            state=torch.stack([c.state for c in caches]))


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

    def _logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], x, cfg.vocab_size,
                       fp32=cfg.logits_fp32)

    @torch.no_grad()
    def forward(self, params, tokens):
        """Teacher-forced logits (B, S, V) and the MoE aux loss summed over
        the MoE layers (zero for a dense plan), as the reference returns
        them (``transformer.py:325-345``)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        aux = [torch.zeros((), device=tokens.device)]

        def moe_fn(pm, h):
            out, layer_aux = moe_forward(cfg, pm, h, return_aux=True)
            aux[0] = aux[0] + layer_aux
            return out

        for seg, _, p in self.layers(params):
            mlp_fn = moe_fn if seg.mlp_kind == "moe" else None
            if seg.mixer == "ssm":
                x = ssm_layer(cfg, p, x)
            elif seg.mixer == "mla":
                x = mla_forward_layer(cfg, p, x, positions, mlp_fn)
            else:
                def attend(q, k, v, window=seg_window(cfg, seg)):
                    return attn.blockwise_attention(q, k, v, causal=True,
                                                    window=window)

                x = attn.gqa_layer(cfg, p, x, positions, attend, mlp_fn)
        return self._logits(params, x), aux[0]

    def _require_ssm(self, what: str):
        if any(seg.mixer != "ssm" for seg in self.plan):
            raise NotImplementedError(
                f"{self.cfg.arch_id}: {what} is ported for the SSM plan "
                "only (ring KV caches come with hymba)")

    def init_cache(self, batch: int, *, device="cuda"):
        """Empty decode caches, one :class:`SSMCache` per segment: the conv
        window in the model type and the float32 state, each with the
        segment's stacked layer axis. An SSM cache's size does not depend
        on the sequence length (the reference's ``seq_len`` argument sizes
        ring KV caches, which come with hymba)."""
        self._require_ssm("init_cache")
        cfg = self.cfg
        device = resolve_device(device)
        caches = []
        for seg in self.plan:
            lead = (seg.n,) if seg.n > 1 else ()
            caches.append(ssm_mod.SSMCache(
                conv=torch.zeros(lead + (batch, cfg.ssm_conv_width - 1,
                                         ssm_mod.conv_dim(cfg)),
                                 dtype=cfg.torch_dtype, device=device),
                state=torch.zeros(lead + (batch, cfg.ssm_heads,
                                          cfg.ssm_head_dim, cfg.ssm_state),
                                  dtype=torch.float32, device=device)))
        return caches

    @torch.no_grad()
    def prefill(self, params, tokens):
        """Full prompt pass. Returns the last position's logits (B, V) and
        the decode caches after the whole prompt (``_seed_caches``' SSM
        branch: the forward pass's conv tail and final state)."""
        self._require_ssm("prefill")
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        caches = []
        for seg, p_seg in zip(self.plan, params["segments"]):
            per_layer = []
            for j in range(seg.n):
                p = p_seg if seg.n == 1 else layer_params(p_seg, j)
                x, c = ssm_layer(cfg, p, x, return_cache=True)
                per_layer.append(c)
            caches.append(per_layer[0] if seg.n == 1
                          else _stack_caches(per_layer))
        return self._logits(params, x[:, -1:])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, params, tokens, pos, caches):
        """tokens: (B, 1); pos: (B,) (unused by an SSM layer). Returns the
        logits (B, V) and new caches; the input caches are not changed."""
        self._require_ssm("decode_step")
        del pos
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        new_caches = []
        for seg, p_seg, cache in zip(self.plan, params["segments"], caches):
            per_layer = []
            for j in range(seg.n):
                p = p_seg if seg.n == 1 else layer_params(p_seg, j)
                c = cache if seg.n == 1 else ssm_mod.SSMCache(
                    conv=cache.conv[j], state=cache.state[j])
                h = rms_norm(p["ln1"], x, cfg.norm_eps)
                out, c = ssm_mod.ssm_decode(cfg, p["ssm"], h, c)
                x = x + out
                per_layer.append(c)
            new_caches.append(per_layer[0] if seg.n == 1
                              else _stack_caches(per_layer))
        return self._logits(params, x)[:, 0], new_caches
