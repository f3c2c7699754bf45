"""Mamba2-1.3B — SSD state-space duality, attention-free [arXiv:2405.21060].

48L d_model=2048 vocab=50280, ssm_state=128, d_inner=4096, head_dim=64
(64 SSD heads). No attention and no MLP: the Mamba2 block subsumes both.
The decode cache is a constant-size state, so the paged engine does not
serve it; ``Model.prefill`` and ``Model.decode_step`` do.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)
