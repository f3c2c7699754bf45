"""DeepSeek-V2 236B — MLA + fine-grained MoE [arXiv:2405.04434].

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400; MLA kv_lora_rank=512;
2 shared + 160 routed experts, top-6; first layer dense (d_ff=12288 per the
paper's dense-layer intermediate size).
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,  # MLA: per-head K/V are decompressed from the shared latent
    head_dim=128,
    d_ff=12288,  # dense MLP hidden (first_k_dense layers)
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    first_k_dense=1,
)
