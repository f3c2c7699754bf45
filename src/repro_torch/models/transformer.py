"""The transformer stack (``repro.models.transformer``) for every plan of
the reference: dense GQA, global or sliding window (danube:
``[24 x swa-dense]``), MoE on GQA (llama4-scout: ``[48 x gqa-moe]``), MLA +
MoE (deepseek-v2: ``[1 x mla-dense, 59 x mla-moe]``; a MoE plan starts
with its ``first_k_dense`` dense layers), the attention-free SSM plan
(mamba2: ``[48 x ssm]``), the hybrid plan, attention and SSM heads side
by side in every layer (hymba: ``[1 x global, 15 x swa] x 2``), and the
encoder-decoder plan (seamless-m4t: an encoder ``[12 x gqa-dense]`` of
non-causal self-attention, and decoder layers ``[12 x gqa-dense, cross]``
that attend over the encoder's output after their self-attention), and a
stack whose config lists each layer's mixer (``layer_types``: granite-4.0-
h-small, ``[5 x ssm-moe, gqa-moe, 9 x ssm-moe, gqa-moe, ...]``, a Mamba-2
or a NoPE GQA mixer before each layer's MoE), in runs of one mixer.

Media (``frontend`` "vision" or "audio") are precomputed embeddings that
replace the first positions of the embedded tokens (``_embed_with_media``):
of the decoder's input for a vision model (internvl2), of the encoder's
for an audio one (seamless); the token ids under them are ignored.

A model is a sequence of **segments**: runs of identical layers whose
parameters are stacked along a leading layer axis, exactly as the
reference stores them (``transformer.py:319``). The reference scans over
that axis; here a Python loop runs over the layers, each stacked leaf
unbound once per segment (:func:`unstack_layers`). ``Model.forward`` is the
teacher-forced oracle of the engine tests and of ``chip_smoke.py``, in
plain PyTorch attention, under ``no_grad``; an MLA layer there decompresses
the latent and runs standard attention (``mla_forward``), where the engine
attends over the latent.

``Model.loss`` is the training loss (``transformer.py:387-393``): the
forward's body with gradients, the plain ``blockwise_attention`` and the
differentiable ``ssm.ssd_chunked`` (no kernel: the kernels have no
backward, and their wrappers refuse a call that autograd would record),
each layer returning its MoE aux loss. ``Model(cfg, remat=True)`` runs
each layer under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of the layer scan), recomputing its activations in the
backward.

``Model.prefill`` / ``Model.decode_step`` serve every plan from per-segment
decode caches, as the reference's do (``transformer.py:396-525``): a GQA
segment keeps a ring-buffer :class:`KVCache` (capacity the window in a
sliding-window segment, else the sequence capacity), an MLA segment a
latent :class:`MLACache`, an SSM segment an :class:`SSMCache` (conv tail
and float32 state), a hybrid one the pair ``(KVCache, SSMCache)``, and a
cross segment the dict ``{"self": KVCache, "ck", "cv"}`` with the
encoder's K/V (B, S_enc, Hkv, Dh) of each layer. Leaves carry the
segment's stacked layer axis where it has more than one layer. On CUDA
tensors the prefill's attention launches the ``flash_prefill`` kernel
(its engine form, with ``blockwise_attention``'s numerics): causal
self-attention, the encoder's non-causal self-attention and the decoder's
cross-attention; the SSM heads launch the ``ssd_scan`` kernel. The decode
attention, self and cross, is plain PyTorch, as the reference's is XLA.
The paged engine serves only uniform GQA or MLA stacks without
cross-attention; hybrid, SSM and encoder-decoder models run here.

Every entry point takes ``policy`` (``models.layers.ShardingPolicy``),
threaded to the reference's hook sites. Under a mesh policy
(``launch.sharding.MeshPolicy``: DTensor parameters and inputs) the
calls run in ``policy.scope()`` and take the plain attention and scan.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_prefill import prefill_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import NO_POLICY, ShardingPolicy, \
    cross_entropy, embed_tokens, logits_of, mlp, residual, rms_norm
from repro_torch.models.moe import moe_forward


@dataclasses.dataclass(frozen=True)
class Segment:
    n: int
    mixer: str  # "gqa" | "mla" | "ssm" | "hybrid"
    mlp_kind: str  # "dense" | "moe" | "none"
    attn_kind: str  # "global" | "swa" | "none"
    cross: bool = False  # decoder cross-attention (encoder-decoder)


def stack_plan(cfg: ArchConfig) -> List[Segment]:
    """The reference's decoder plan (``transformer.py:51-76``): a GQA or
    MLA stack, dense or MoE, whose segments attend over an encoder's
    output where the config has one (``cross``), an SSM stack or a hybrid
    one, or the runs of one mixer of a ``layer_types`` stack."""
    if cfg.layer_types is not None:
        return _typed_plan(cfg)
    if cfg.family == "ssm":
        if cfg.d_ff:
            raise NotImplementedError(
                f"{cfg.arch_id}: an SSM plan with an MLP is not ported yet")
        return [Segment(cfg.num_layers, "ssm", "none", "none")]
    if cfg.is_hybrid:
        # a global layer, then a run of window layers, repeated
        segs, i = [], 0
        every = cfg.global_attn_every or cfg.num_layers
        while i < cfg.num_layers:
            segs.append(Segment(1, "hybrid", "dense", "global"))
            run = min(every - 1, cfg.num_layers - i - 1)
            if run > 0:
                segs.append(Segment(run, "hybrid", "dense", "swa"))
            i += 1 + run
        return segs
    mixer = "mla" if cfg.attention == "mla" else "gqa"
    attn_kind = "swa" if cfg.sliding_window else "global"
    if cfg.is_moe:
        segs = []
        if cfg.first_k_dense:
            segs.append(Segment(cfg.first_k_dense, mixer, "dense",
                                attn_kind, cross=cfg.is_encdec))
        segs.append(Segment(cfg.num_layers - cfg.first_k_dense, mixer, "moe",
                            attn_kind, cross=cfg.is_encdec))
        return segs
    return [Segment(cfg.num_layers, mixer, "dense", attn_kind,
                    cross=cfg.is_encdec)]


def _typed_plan(cfg: ArchConfig) -> List[Segment]:
    """A ``layer_types`` stack: each run of layers of one mixer (and one
    MLP kind) one segment; the attention global, NoPE where the config
    says so."""
    if len(cfg.layer_types) != cfg.num_layers:
        raise ValueError(f"{cfg.arch_id}: {len(cfg.layer_types)} layer "
                         f"types for {cfg.num_layers} layers")
    if cfg.sliding_window:
        raise NotImplementedError(f"{cfg.arch_id}: a window in a "
                                  "layer_types stack is not ported")

    mlp_kind = "moe" if cfg.is_moe else "dense" if cfg.d_ff else "none"

    def kind(i):
        mixer = cfg.mixer_of(i)
        return mixer, mlp_kind, "none" if mixer == "ssm" else "global"

    segs = []
    for i in range(cfg.num_layers):
        if segs and (segs[-1].mixer, segs[-1].mlp_kind,
                     segs[-1].attn_kind) == kind(i):
            segs[-1] = dataclasses.replace(segs[-1], n=segs[-1].n + 1)
        else:
            segs.append(Segment(1, *kind(i)))
    return segs


def encoder_plan(cfg: ArchConfig) -> List[Segment]:
    """The encoder's one segment of dense GQA layers
    (``transformer.py:79-80``); run non-causally."""
    return [Segment(cfg.encoder_layers, "gqa", "dense", "global")]


def _layer_axis_whole(t):
    """A stacked DTensor leaf of per-layer vectors (norm scales, biases),
    replicated: the layout rules treat the stack as a matrix (layers over
    data, the vector over ``model``), but a layer loop reads every layer,
    and a vector sharded over ``model`` would pull the activations it
    scales onto that layout. Stacked matrices shard only their own axes."""
    if isinstance(t, DTensor) and t.dim() == 2 and \
            any(isinstance(pl, Shard) for pl in t.placements):
        return t.redistribute(t.device_mesh,
                              [Replicate()] * len(t.placements))
    return t


def layer_params(p_seg, i: int):
    """Parameters of layer ``i`` of a stacked segment (views, no copy)."""
    if isinstance(p_seg, dict):
        return {k: layer_params(v, i) for k, v in p_seg.items()}
    return _layer_axis_whole(p_seg)[i]


def unstack_layers(p_seg, n: int):
    """The ``n`` layers' parameters of a segment (views, no copy); a
    one-layer segment is stored without the stacked axis. Each leaf is
    unbound once: the backward of an unbind is one stack, where indexing
    each layer would zero-fill and add a gradient of the whole stack per
    layer (O(n^2) bytes)."""
    if n == 1:
        return [p_seg]
    if isinstance(p_seg, dict):
        parts = {k: unstack_layers(v, n) for k, v in p_seg.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(_layer_axis_whole(p_seg)))


def seg_window(cfg: ArchConfig, seg: Segment):
    return cfg.sliding_window if seg.attn_kind == "swa" else None


def _plain_attention(q, k, v, window, causal=True, policy=NO_POLICY,
                     scale=None):
    return attn.blockwise_attention(q, k, v, causal=causal, window=window,
                                    scale=scale, policy=policy)


def _kernel_attention(q, k, v, window, causal=True, policy=NO_POLICY,
                      scale=None):
    return prefill_attention(q, k, v, window=window, causal=causal,
                             scale=scale)


def _scan(policy: ShardingPolicy):
    """The SSM heads' scan: the kernel's wrapper, or the plain chunked scan
    where the policy takes no kernel."""
    return ssd_scan if policy.kernels else ssm_mod.ssd_chunked


def mlp_residual(cfg, seg: Segment, p, x, mlp_fn, policy=NO_POLICY):
    """The pre-norm residual MLP of a layer (``mlp_fn`` for MoE)."""
    if seg.mlp_kind == "none":
        return x
    h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
    return residual(cfg, x, mlp(p["mlp"], h2, policy) if mlp_fn is None
                    else mlp_fn(p["mlp"], h2))


def _layer_forward(cfg, seg: Segment, p, x, positions, *, attention,
                   mlp_fn=None, collect: bool = False, causal: bool = True,
                   enc_out=None, scan=ssd_scan,
                   policy: ShardingPolicy = NO_POLICY):
    """One full-sequence layer (``transformer.py:109-177``).
    ``attention(q, k, v, window, causal, policy) -> ctx`` is the attention
    of GQA, hybrid and cross layers; ``causal=False`` in the encoder;
    ``scan`` the SSM heads' chunked scan. A cross segment attends over ``enc_out`` (B,
    S_enc, D) after its self-attention. ``mlp_fn`` replaces the layer's
    MLP. Returns (x, aux, seed): the MoE load-balance loss of the layer
    (float32; zero but in a MoE layer run without ``mlp_fn``), and with
    ``collect`` the seed of the decode cache (gqa: (k, v); mla: (ckv,
    krope); ssm: SSMCache; hybrid: ((k, v), SSMCache); a cross segment:
    (that seed, (ck, cv))), else None. ``policy``'s hooks as the
    reference's."""
    window = seg_window(cfg, seg)
    # the config's softmax scale, passed where it has one
    scaled = {} if cfg.attn_scale is None else {"scale": cfg.attn_scale}

    def attend(q, k, v):
        return attention(q, k, v, window, causal, policy, **scaled)

    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    seed = None
    if seg.mixer == "gqa":
        out = attn.gqa_forward(cfg, p["attn"], h, positions,
                               return_kv=collect, attend=attend,
                               policy=policy)
        if collect:
            out, seed = out
        x = residual(cfg, x, out)
    elif seg.mixer == "mla":
        out = attn.mla_forward(cfg, p["attn"], h, positions,
                               return_latent=collect, policy=policy)
        if collect:
            out, seed = out
        x = residual(cfg, x, out)
    elif seg.mixer == "ssm":
        out = ssm_mod.ssm_forward(cfg, p["ssm"], h, return_cache=collect,
                                  scan=scan, policy=policy)
        if collect:
            out, seed = out
        x = residual(cfg, x, out)
    else:  # hybrid: parallel heads, averaged fusion
        a = attn.gqa_forward(cfg, p["attn"], h, positions,
                             return_kv=collect, attend=attend, policy=policy)
        m = ssm_mod.ssm_forward(cfg, p["ssm"], h, return_cache=collect,
                                scan=scan, policy=policy)
        if collect:
            (a, kv), (m, sc) = a, m
            seed = (kv, sc)
        x = x + 0.5 * (a + m)
    if seg.cross:
        hc = rms_norm(p["ln_cross"], x, cfg.norm_eps)
        ckv = attn.encode_kv(cfg, p["cross"], enc_out)
        x = x + attn.gqa_forward(
            cfg, p["cross"], hc, positions, kv_override=ckv,
            attend=lambda q, k, v: attention(q, k, v, None, False, policy),
            policy=policy)
        if collect:
            seed = (seed, ckv)
    if seg.mlp_kind == "moe" and mlp_fn is None:
        h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
        out, aux = moe_forward(cfg, p["mlp"], h2, policy=policy,
                               return_aux=True)
        return residual(cfg, x, out), aux, seed
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return mlp_residual(cfg, seg, p, x, mlp_fn, policy), aux, seed


def mla_forward_layer(cfg, p, x, positions, mlp_fn=None):
    """One full-sequence MLA layer as ``Model.forward`` runs it: pre-norm
    residual ``mla_forward`` (the decompressed form), then the pre-norm
    residual MLP (``mlp_fn`` for MoE)."""
    return _layer_forward(cfg, Segment(1, "mla", "dense", "global"), p, x,
                          positions, attention=_plain_attention,
                          mlp_fn=mlp_fn)[0]


def _layer_decode(cfg, seg: Segment, p, x, pos, cache,
                  policy: ShardingPolicy = NO_POLICY):
    """One-token layer step against its cache (``transformer.py:
    180-223``); a cross segment then attends over its cached encoder K/V.
    Returns (x, the new cache)."""
    window = seg_window(cfg, seg)
    cross = cache if seg.cross else None
    if seg.cross:
        cache = cross["self"]
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    if seg.mixer == "gqa":
        out, cache = attn.gqa_decode(cfg, p["attn"], h, cache, pos,
                                     window=window, policy=policy)
        x = residual(cfg, x, out)
    elif seg.mixer == "mla":
        out, cache = attn.mla_decode(cfg, p["attn"], h, cache, pos,
                                     policy=policy)
        x = residual(cfg, x, out)
    elif seg.mixer == "ssm":
        out, cache = ssm_mod.ssm_decode(cfg, p["ssm"], h, cache,
                                        policy=policy)
        x = residual(cfg, x, out)
    else:
        kv_c, ssm_c = cache
        a, kv_c = attn.gqa_decode(cfg, p["attn"], h, kv_c, pos,
                                  window=window, policy=policy)
        m, ssm_c = ssm_mod.ssm_decode(cfg, p["ssm"], h, ssm_c,
                                      policy=policy)
        x = x + 0.5 * (a + m)
        cache = (kv_c, ssm_c)
    if seg.cross:
        hc = rms_norm(p["ln_cross"], x, cfg.norm_eps)
        out, _ = attn.gqa_decode(cfg, p["cross"], hc, None, pos,
                                 kv_override=(cross["ck"], cross["cv"]),
                                 policy=policy)
        x = x + out
        cache = dict(cross, self=cache)
    mlp_fn = (lambda pm, h2: moe_forward(cfg, pm, h2, policy=policy)) \
        if seg.mlp_kind == "moe" else None
    return mlp_residual(cfg, seg, p, x, mlp_fn, policy), cache


# -- cache trees: NamedTuples, tuples and dicts of tensors --------------------

def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        parts = [_tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(t0)(*parts) if hasattr(t0, "_fields") else tuple(parts)
    return fn(*trees)


def _tree_index(tree, i: int):
    """Layer ``i`` of a stacked cache tree (views)."""
    return _tree_map(lambda t: t[i], tree)


def _tree_stack(trees):
    return _tree_map(lambda *ts: torch.stack(ts), *trees)


def segment_cache_capacity(cfg, seg: Segment, seq_len: int) -> int:
    """A window segment's ring holds the window; any other the sequence."""
    if seg.attn_kind == "swa" and cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _empty_segment_cache(cfg, seg: Segment, batch: int, seq_len: int,
                         device, enc_len: int = 0):
    """Zeros in the model type, int32 positions -1, the float32 SSM state;
    a cross segment's ``{"self", "ck", "cv"}`` with ``enc_len`` encoder
    positions; the segment's layer axis first where it has several layers
    (``transformer.py:236-273``)."""
    cap = segment_cache_capacity(cfg, seg, seq_len)
    lead = (seg.n,) if seg.n > 1 else ()
    dtype = cfg.torch_dtype

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    def empty_pos():
        return torch.full(lead + (batch, cap), -1, dtype=torch.int32,
                          device=device)

    def kv():
        shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
        return attn.KVCache(k=zeros(*shape), v=zeros(*shape), pos=empty_pos())

    def ssmc():
        return ssm_mod.SSMCache(
            conv=zeros(batch, cfg.ssm_conv_width - 1, ssm_mod.conv_dim(cfg)),
            state=zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                        cfg.ssm_state, dt=torch.float32))

    if seg.cross:
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        base = _empty_segment_cache(cfg, dataclasses.replace(seg, cross=False),
                                    batch, seq_len, device)
        return {"self": base, "ck": zeros(*shape), "cv": zeros(*shape)}
    if seg.mixer == "gqa":
        return kv()
    if seg.mixer == "mla":
        return attn.MLACache(ckv=zeros(batch, cap, cfg.kv_lora_rank),
                             krope=zeros(batch, cap, cfg.qk_rope_head_dim),
                             pos=empty_pos())
    if seg.mixer == "ssm":
        return ssmc()
    return kv(), ssmc()


def _ring_set(buf, new, slots, take: int, s: int, ndims: int = 2):
    """buf: ([n,] B, cap, ...); new: ([n,] B, s, ...): the last ``take``
    positions of ``new`` into ring ``slots``. ``ndims``: trailing dims
    after the sequence axis (``transformer.py:511-517``)."""
    dim = buf.dim() - 1 - ndims
    return buf.index_copy(dim, slots,
                          new.narrow(dim, s - take, take).to(buf.dtype))


def _ring_set_pos(buf, posvec, slots):
    """buf: ([n,] B, cap) int32: absolute positions into ring ``slots``."""
    val = posvec.to(torch.int32).expand(buf.shape[:-1] + posvec.shape)
    return buf.index_copy(buf.dim() - 1, slots, val.contiguous())


class Model:
    """Parameters are passed in, as in the reference: a nested dict from
    :func:`repro_torch.bridge.init_params` or the bridge; an
    encoder-decoder model's encoder under ``params["encoder"]``
    (``{"segments", "final_norm"}``)."""

    def __init__(self, cfg: ArchConfig, remat: bool = False):
        """``remat``: :meth:`loss` recomputes each layer's activations in
        the backward (``transformer.py:281-289, 347``)."""
        self.cfg = cfg
        self.plan = stack_plan(cfg)
        self.enc_plan = encoder_plan(cfg) if cfg.is_encdec else []
        self.remat = remat

    def layers(self, params):
        """Yield ``(seg, layer_index, layer_params)`` over the decoder."""
        li = 0
        for seg, p_seg in zip(self.plan, params["segments"]):
            for j in range(seg.n):
                # a one-layer segment is stored without the stacked axis
                yield seg, li, p_seg if seg.n == 1 else layer_params(p_seg, j)
                li += 1

    def _logits(self, params, x, policy=NO_POLICY):
        cfg = self.cfg
        x = rms_norm(params["final_norm"], x, cfg.norm_eps)
        return logits_of(cfg, params["embed"], x, policy)

    def _run_stack(self, plan, seg_params, x, *, attention, collect: bool,
                   causal: bool = True, enc_out=None, scan=ssd_scan,
                   remat: bool = False, policy=NO_POLICY):
        """Run every layer of ``plan`` on the embedded ``x``, each under
        ``checkpoint`` with ``remat``. Returns (x, aux summed over the MoE
        layers in layer order, one seed per segment stacked along its layer
        axis)."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        seeds = []
        for seg, p_seg in zip(plan, seg_params):
            def layer(p, x, seg=seg):
                return _layer_forward(cfg, seg, p, x, positions,
                                      attention=attention, collect=collect,
                                      causal=causal, enc_out=enc_out,
                                      scan=scan, policy=policy)

            per_layer = []
            for p in unstack_layers(p_seg, seg.n):
                x, layer_aux, seed = checkpoint(
                    layer, p, x, use_reentrant=False) if remat \
                    else layer(p, x)
                aux = aux + layer_aux
                per_layer.append(seed)
            if collect:
                seeds.append(per_layer[0] if seg.n == 1
                             else _tree_stack(per_layer))
        return x, aux, seeds

    def _embed_with_media(self, params, tokens, media, policy=NO_POLICY):
        """Embedded tokens whose first ``media.shape[1]`` positions are the
        media embeddings (B, M, D) instead (``transformer.py:353-358``)."""
        x = embed_tokens(self.cfg, params["embed"], tokens, policy)
        if media is not None:
            m = media.shape[1]
            x = torch.cat([media.to(x.dtype), x[:, m:]], dim=1)
        return x

    def encode(self, params, encoder_tokens, media=None, *,
               attention=_plain_attention, remat: bool = False,
               policy: ShardingPolicy = NO_POLICY):
        """The encoder's output (B, S_enc, D): embedded tokens (and media),
        non-causal self-attention layers, the encoder's final norm
        (``transformer.py:360-365``)."""
        x = self._embed_with_media(params, encoder_tokens, media, policy)
        x, _, _ = self._run_stack(self.enc_plan,
                                  params["encoder"]["segments"], x,
                                  attention=attention, collect=False,
                                  causal=False, remat=remat, policy=policy)
        return rms_norm(params["encoder"]["final_norm"], x,
                        self.cfg.norm_eps)

    def _decoder_input(self, params, tokens, media, encoder_tokens,
                       attention, remat: bool = False, policy=NO_POLICY):
        """(embedded decoder input, encoder output or None): media go to
        the encoder of an audio model and to the decoder otherwise
        (``transformer.py:372-378``)."""
        enc_out = None
        if self.cfg.is_encdec:
            audio = self.cfg.frontend == "audio"
            enc_out = self.encode(params, encoder_tokens,
                                  media if audio else None,
                                  attention=attention, remat=remat,
                                  policy=policy)
            media = None if audio else media
        return self._embed_with_media(params, tokens, media, policy), enc_out

    def _forward(self, params, tokens, media, encoder_tokens, *, scan,
                 remat: bool, policy=NO_POLICY):
        """The body of :meth:`forward` and :meth:`loss`: logits and aux."""
        x, enc_out = self._decoder_input(params, tokens, media,
                                         encoder_tokens, _plain_attention,
                                         remat, policy)
        x, aux, _ = self._run_stack(self.plan, params["segments"], x,
                                    attention=_plain_attention,
                                    collect=False, enc_out=enc_out,
                                    scan=scan, remat=remat, policy=policy)
        return self._logits(params, x, policy), aux

    @torch.no_grad()
    def forward(self, params, tokens, *, media=None, encoder_tokens=None,
                policy: ShardingPolicy = NO_POLICY):
        """Teacher-forced logits (B, S, V) and the MoE aux loss summed over
        the MoE layers (zero for other plans), as the reference returns
        them (``transformer.py:368-385``). ``media``: (B, M, D) embeddings
        in place of the first M positions; ``encoder_tokens``: (B, S_enc)
        the encoder's input of an encoder-decoder model. Attention is the
        plain ``blockwise_attention`` on any device; the SSM heads take the
        ``ssd_scan`` kernel on CUDA, except under a mesh policy (DTensor
        parameters and inputs), which runs the plain scan."""
        with policy.scope():
            return self._forward(params, tokens, media, encoder_tokens,
                                 scan=_scan(policy), remat=False,
                                 policy=policy)

    def loss(self, params, batch, *, policy: ShardingPolicy = NO_POLICY):
        """The training loss (``transformer.py:387-393``): mean next-token
        cross-entropy of ``batch["tokens"]`` against ``batch["labels"]``
        shifted by one, plus 0.01 x the MoE aux loss. ``batch`` may carry
        ``media`` and ``encoder_tokens`` as :meth:`forward` takes them. No
        kernel runs: plain attention and :func:`ssm.ssd_chunked`. Under a
        mesh policy the caller runs the backward in ``policy.scope()``
        too (``training.train_loop.make_train_step`` does)."""
        with policy.scope():
            logits, aux = self._forward(
                params, batch["tokens"], batch.get("media"),
                batch.get("encoder_tokens"), scan=ssm_mod.ssd_chunked,
                remat=self.remat, policy=policy)
            ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               self.cfg.vocab_size, policy)
            return ce + 0.01 * aux

    def init_cache(self, batch: int, seq_len: int, *, device="cuda",
                   enc_len: int = 0):
        """Empty decode caches for ``batch`` sequences of up to
        ``seq_len`` positions, one per segment (``transformer.py:
        396-401``); a cross segment's holds ``enc_len`` encoder positions.
        An SSM cache's size does not depend on ``seq_len``."""
        device = resolve_device(device)
        return [_empty_segment_cache(self.cfg, seg, batch, seq_len, device,
                                     enc_len)
                for seg in self.plan]

    @torch.no_grad()
    def prefill(self, params, tokens, *, seq_capacity: int, media=None,
                encoder_tokens=None, last_idx: Optional[torch.Tensor] = None,
                return_raw_kv: bool = False,
                policy: ShardingPolicy = NO_POLICY):
        """Full prompt pass (``transformer.py:403-433``). Returns the
        logits (B, V) at ``last_idx`` (default the last position) and the
        decode caches for up to ``seq_capacity`` positions, ring buffers
        seeded with the prompt's last positions (and a cross segment's
        encoder K/V); with ``return_raw_kv`` the per-segment seeds of the
        whole prompt instead. ``media`` and ``encoder_tokens`` as in
        :meth:`forward`. On CUDA the attention (the encoder's, the
        decoder's self- and cross-attention) launches ``flash_prefill``
        and the SSM heads ``ssd_scan``; under a mesh policy the plain
        versions run (a kernel wrapper refuses a DTensor)."""
        with policy.scope():
            return self._prefill(params, tokens, seq_capacity, media,
                                 encoder_tokens, last_idx, return_raw_kv,
                                 policy)

    def _prefill(self, params, tokens, seq_capacity, media, encoder_tokens,
                 last_idx, return_raw_kv, policy):
        b, s = tokens.shape
        attention = _kernel_attention if policy.kernels \
            else _plain_attention
        x, enc_out = self._decoder_input(params, tokens, media,
                                         encoder_tokens, attention,
                                         policy=policy)
        x, _, seeds = self._run_stack(self.plan, params["segments"], x,
                                      attention=attention, collect=True,
                                      enc_out=enc_out, scan=_scan(policy),
                                      policy=policy)
        if last_idx is None:
            last_h = x[:, -1]
        else:
            last_h = x.gather(1, last_idx.long()[:, None, None].expand(
                b, 1, x.shape[-1]))[:, 0]
        logits = self._logits(params, last_h[:, None, :], policy)[:, 0]
        if return_raw_kv:
            return logits, seeds
        return logits, self._seed_caches(seeds, b, s, seq_capacity,
                                         tokens.device)

    def _seed_caches(self, seeds, b: int, s: int, capacity: int, device):
        """Prefill seeds into ring-buffer decode caches
        (``transformer.py:435-481``)."""
        caches = []
        for seg, seed in zip(self.plan, seeds):
            cross_kv = None
            if seg.cross:
                seed, cross_kv = seed
                seg = dataclasses.replace(seg, cross=False)  # the ring only
            caches.append(self._seed_ring(seg, seed, b, s, capacity, device))
            if cross_kv is not None:
                ck, cv = cross_kv
                caches[-1] = {"self": caches[-1], "ck": ck, "cv": cv}
        return caches

    def _seed_ring(self, seg: Segment, seed, b: int, s: int, capacity: int,
                   device):
        """One segment's decode cache from its prefill seed."""
        cfg = self.cfg
        if seg.mixer == "ssm":
            return seed  # the forward pass's conv tail and state
        cap = segment_cache_capacity(cfg, seg, capacity)
        take = min(cap, s)
        posvec = torch.arange(s - take, s, device=device)
        slots = posvec % cap
        empty = _empty_segment_cache(cfg, seg, b, capacity, device)
        if seg.mixer == "mla":
            (ckv, krope), e = seed, empty
            return attn.MLACache(
                ckv=_ring_set(e.ckv, ckv, slots, take, s, ndims=1),
                krope=_ring_set(e.krope, krope, slots, take, s, ndims=1),
                pos=_ring_set_pos(e.pos, posvec, slots))
        hybrid = seg.mixer == "hybrid"
        k, v = seed[0] if hybrid else seed
        e = empty[0] if hybrid else empty
        kvc = attn.KVCache(k=_ring_set(e.k, k, slots, take, s),
                           v=_ring_set(e.v, v, slots, take, s),
                           pos=_ring_set_pos(e.pos, posvec, slots))
        return (kvc, seed[1]) if hybrid else kvc

    @torch.no_grad()
    def decode_step(self, params, tokens, pos, caches, *,
                    policy: ShardingPolicy = NO_POLICY):
        """tokens: (B, 1); pos: (B,) absolute positions. Returns the logits
        (B, V) and new caches (``transformer.py:483-508``); the input
        caches are not changed."""
        cfg = self.cfg
        with policy.scope():
            x = embed_tokens(cfg, params["embed"], tokens, policy)
            new_caches = []
            for seg, p_seg, cache in zip(self.plan, params["segments"],
                                         caches):
                if seg.n == 1:
                    x, c = _layer_decode(cfg, seg, p_seg, x, pos, cache,
                                         policy)
                    new_caches.append(c)
                    continue
                per_layer = []
                for j in range(seg.n):
                    x, c = _layer_decode(cfg, seg, layer_params(p_seg, j), x,
                                         pos, _tree_index(cache, j), policy)
                    per_layer.append(c)
                new_caches.append(_tree_stack(per_layer))
            return self._logits(params, x, policy)[:, 0], new_caches
