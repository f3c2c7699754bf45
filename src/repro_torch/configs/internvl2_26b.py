"""InternVL2-26B — InternViT-6B vision encoder + InternLM2-20B LM [arXiv:2404.16821].

LM backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The ViT + MLP projector frontend is a STUB per the assignment carve-out:
``input_specs`` provides precomputed patch embeddings (256 tokens per image
after pixel-shuffle) prepended to the text sequence.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    attention="gqa",
    rope_theta=1_000_000.0,
    frontend="vision",
    num_media_tokens=256,
)
