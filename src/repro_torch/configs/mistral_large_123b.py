"""Mistral-Large 123B [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    attention="gqa",
    rope_theta=1_000_000.0,
)
