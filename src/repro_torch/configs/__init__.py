"""Architecture configs for the port.

``ArchConfig`` is a copy of ``repro.configs.ArchConfig`` without the JAX
dtype property: :attr:`ArchConfig.torch_dtype` maps the ``dtype`` string to
a ``torch.dtype`` instead. ``get_config`` resolves dashed ids
(``--arch h2o-danube-1.8b``) to a module of this package; ``smoke_config``
returns the reduced variant the CPU tests use (2 layers, d_model 256),
built exactly as the reference builds it. Every arch of the reference has
a module here: its ten ``ARCH_IDS`` and paper-opt-13b, which the
reference has a module for but does not list.

The port's own fields (:data:`PORT_FIELDS`: a per-layer mixer list, NoPE,
a softmax scale, the embedding, residual and logits multipliers, the
shared experts' width) come after the reference's, and their defaults
leave every arch of the reference as it is; :func:`reference_fields` is
a config without them, as the reference's ``ArchConfig`` holds it.
:data:`PORT_ARCH_IDS` are the archs only the port has (granite-4.0-h-
small: Mamba-2 and attention layers in one stack, each with a MoE).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A composable architecture description (field-for-field the
    reference's, so a config moves between the two packages with
    ``dataclasses.asdict``)."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation for the config numbers

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention variants -------------------------------------------------
    attention: str = "gqa"  # gqa | mla | none
    sliding_window: Optional[int] = None  # SWA width (tokens) or None
    # trained context limit; serving sizes per-sequence block tables from it
    max_seq_len: Optional[int] = None
    global_attn_every: Optional[int] = None
    rope_theta: float = 10_000.0
    use_bias: bool = False

    # --- MLA (deepseek-v2) ---------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2 SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- enc-dec / modality frontend -----------------------------------------
    encoder_layers: int = 0
    frontend: str = "none"
    num_media_tokens: int = 0

    gated_mlp: bool = True  # SwiGLU (3 mats) vs plain GeLU MLP (2 mats)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # compute the unembedding in float32 (greedy argmax comparable across
    # implementations; bf16 logits round near-ties onto the same value)
    logits_fp32: bool = False

    # --- the port's own (PORT_FIELDS); the defaults change nothing ----------
    # each layer's mixer as the published config names it ("mamba" or
    # "attention"); None: every layer as ``family`` and ``attention`` say
    layer_types: Optional[Tuple[str, ...]] = None
    use_rope: bool = True  # False: NoPE (no rotary embedding at all)
    attn_scale: Optional[float] = None  # softmax scale; None: 1/sqrt(Dh)
    embedding_multiplier: float = 1.0  # the embedded tokens are scaled
    # each block's output is scaled before it joins the residual stream
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0  # the logits are divided by it
    shared_d_ff: int = 0  # shared experts' width; 0: num_shared x moe_d_ff

    def __post_init__(self):
        if self.layer_types is not None:  # a list (from JSON) as a tuple
            object.__setattr__(self, "layer_types", tuple(self.layer_types))

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def shared_width(self) -> int:
        """The shared experts' one gated MLP's width (0: none)."""
        return self.shared_d_ff or self.num_shared_experts * self.moe_d_ff

    def mixer_of(self, layer: int) -> str:
        """Layer ``layer``'s mixer in a ``layer_types`` stack: "ssm" or
        "gqa"."""
        return LAYER_MIXERS[self.layer_types[layer]]

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    @property
    def supports_long_context(self) -> bool:
        """True where a 524k-token decode is sub-quadratic or of bounded
        memory: an SSM, a hybrid (its attention is windowed), or a window
        (``configs/__init__.py:116-123`` of the reference)."""
        if self.family == "ssm" or self.is_hybrid:
            return True
        return self.sliding_window is not None

    def n_params(self) -> int:
        """Approximate total parameter count (the roofline's MODEL_FLOPS)."""
        return _count(self, active_only=False)

    def n_active_params(self) -> int:
        """Parameters a token touches (MoE: the shared and top-k experts)."""
        return _count(self, active_only=True)


# a published layer type -> the port's mixer
LAYER_MIXERS = {"mamba": "ssm", "attention": "gqa"}
# ArchConfig's fields that the reference's ArchConfig does not have
PORT_FIELDS = ("layer_types", "use_rope", "attn_scale",
               "embedding_multiplier", "residual_multiplier",
               "logits_scaling", "shared_d_ff")


def reference_fields(cfg: ArchConfig) -> dict:
    """``dataclasses.asdict(cfg)`` without :data:`PORT_FIELDS`, each of
    which must be at its default: the reference's ``ArchConfig`` of the
    same arch holds exactly this."""
    out = dataclasses.asdict(cfg)
    for f in dataclasses.fields(ArchConfig):
        if f.name in PORT_FIELDS:
            if out.pop(f.name) != f.default:
                raise ValueError(f"{cfg.arch_id}: {f.name} is the port's "
                                 "own, and not at its default")
    return out


def _count(cfg: ArchConfig, active_only: bool) -> int:
    """The reference's parameter accounting (``configs/__init__.py:
    138-197``), term for term; a ``layer_types`` stack counts each layer's
    own mixer, and the shared experts by their width."""
    d = cfg.d_model
    total = cfg.vocab_size * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d

    def attn_params() -> int:
        if cfg.attention == "mla":
            qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            p = d * cfg.kv_lora_rank + d * cfg.qk_rope_head_dim
            if cfg.q_lora_rank:
                p += d * cfg.q_lora_rank \
                    + cfg.q_lora_rank * cfg.num_heads * qd
            else:
                p += d * cfg.num_heads * qd
            p += cfg.kv_lora_rank * cfg.num_heads \
                * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            p += cfg.num_heads * cfg.v_head_dim * d  # o_proj
            return p
        if cfg.attention == "none":
            return 0
        q = d * cfg.num_heads * cfg.head_dim
        kv = 2 * d * cfg.num_kv_heads * cfg.head_dim
        o = cfg.num_heads * cfg.head_dim * d
        return q + kv + o

    def mlp_params(ff: int) -> int:
        return (3 if cfg.gated_mlp else 2) * d * ff

    def ssm_params() -> int:
        din, h = cfg.ssm_d_inner, cfg.ssm_heads
        g, n = cfg.ssm_groups, cfg.ssm_state
        in_proj = d * (2 * din + 2 * g * n + h)
        conv = cfg.ssm_conv_width * (din + 2 * g * n)
        return in_proj + conv + din * d + 2 * h  # + A_log, D

    per_layer = 0
    for layer in range(cfg.num_layers):
        p = 0
        if cfg.layer_types is not None:
            p += ssm_params() if cfg.mixer_of(layer) == "ssm" \
                else attn_params()
        elif cfg.family == "ssm":
            p += ssm_params()
        elif cfg.is_hybrid:
            p += attn_params() + ssm_params()
        else:
            p += attn_params()
        if cfg.is_moe and layer >= cfg.first_k_dense:
            e = cfg.moe_top_k if active_only else cfg.num_experts
            p += e * mlp_params(cfg.moe_d_ff) + mlp_params(cfg.shared_width)
            p += d * cfg.num_experts  # router
        elif cfg.d_ff:
            p += mlp_params(cfg.d_ff)
        per_layer += p
    total += per_layer
    # the encoder (dense attention + MLP) and the decoder's cross-attention
    if cfg.is_encdec:
        enc = cfg.encoder_layers * (
            4 * d * cfg.num_heads * cfg.head_dim + mlp_params(cfg.d_ff))
        cross = cfg.num_layers * 4 * d * cfg.num_heads * cfg.head_dim
        total += enc + cross
    return total


# ----------------------------------------------------------------------------
# input shapes of the dry-run (``configs/__init__.py:203-218``)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


class Spec(NamedTuple):
    """A model input's shape and dtype, allocated nowhere (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Spec]:
    """Stand-ins for every model input of ``shape`` (``configs/__init__.py:
    277-306``): tokens and labels to train, tokens to prefill (and the
    encoder's tokens at a quarter of the length, and media embeddings),
    one token and its position to decode against a cache of ``seq_len``."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    media = {}
    if cfg.frontend != "none":
        media["media"] = Spec((b, cfg.num_media_tokens, cfg.d_model),
                              torch.bfloat16)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": Spec((b, s), i32)}
        if shape.kind == "train":
            out["labels"] = Spec((b, s), i32)
        if cfg.is_encdec:
            out["encoder_tokens"] = Spec((b, s // 4), i32)
        out.update(media)
        return out
    return {"tokens": Spec((b, 1), i32), "positions": Spec((b,), i32)}


ARCH_IDS = [
    "h2o-danube-1.8b",
    "mamba2-1.3b",
    "paper-opt-13b",
    "granite-20b",
    "command-r-35b",
    "mistral-large-123b",
    "llama4-scout-17b-a16e",
    "deepseek-v2-236b",
    "hymba-1.5b",
    "seamless-m4t-medium",
    "internvl2-26b",
]
# archs the reference package has no module for
PORT_ARCH_IDS = [
    "granite-4.0-h-small",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "p")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS + PORT_ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r} (known: "
                         f"{', '.join(ARCH_IDS + PORT_ARCH_IDS)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    """Reduced variant of the same family: 2 layers, d_model 256, <= 4
    experts, the reference's reduction rules (``repro.configs.
    smoke_config``)."""
    cfg = get_config(arch_id)
    heads = min(cfg.num_heads, 4) or 0
    kv = min(cfg.num_kv_heads, heads) if cfg.num_kv_heads else 0
    updates = dict(
        num_layers=2,
        d_model=256,
        num_heads=heads,
        num_kv_heads=max(kv, 1) if cfg.attention != "none" else 0,
        head_dim=64 if cfg.attention != "none" else 0,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        encoder_layers=2 if cfg.is_encdec else 0,
        num_media_tokens=8 if cfg.frontend != "none" else 0,
    )
    if cfg.attention == "mla":
        updates.update(kv_lora_rank=64, q_lora_rank=96, qk_nope_head_dim=32,
                       qk_rope_head_dim=16, v_head_dim=32)
    if cfg.is_moe:
        # capacity_factor = E / top_k: no token is dropped, so smoke decode
        # matches the teacher-forced oracle exactly
        updates.update(num_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                       moe_d_ff=128,
                       num_shared_experts=min(cfg.num_shared_experts, 1),
                       capacity_factor=4.0)
    if cfg.ssm_state:
        updates.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
    if cfg.sliding_window:
        updates.update(sliding_window=64)
    if cfg.layer_types is not None:
        # one layer of each kind, in the order the stack first has them
        kinds = tuple(dict.fromkeys(cfg.layer_types))
        updates.update(layer_types=kinds, num_layers=len(kinds))
    if cfg.shared_d_ff:
        updates.update(shared_d_ff=2 * updates.get("moe_d_ff", cfg.moe_d_ff))
    return dataclasses.replace(cfg, **updates)
