"""Command-R 35B — dense GQA, no biases [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    attention="gqa",
    rope_theta=8_000_000.0,
    use_bias=False,
    tie_embeddings=True,
)
