"""Granite-20B code model — llama-arch with MQA [arXiv:2405.04324].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="granite-20b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    attention="gqa",
    use_bias=True,
    gated_mlp=False,  # GPT-BigCode lineage keeps biases
)
