"""Hymba-1.5B — hybrid parallel attention + Mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba runs attention and SSM heads *in parallel within the same layer* and uses
sliding-window attention on most layers with a few global-attention layers —
which is what makes ``long_500k`` feasible for this arch.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention="gqa",
    sliding_window=1024,
    global_attn_every=16,  # layers 0, 16 use global attention (paper: first/middle/last)
    ssm_state=16,
    ssm_head_dim=50,  # d_inner=3200, 64 ssm heads of dim 50
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)
