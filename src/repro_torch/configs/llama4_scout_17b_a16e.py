"""Llama-4 Scout 17B-active/16E [hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff(expert)=8192 vocab=202048; MoE 16 routed
experts top-1 + 1 shared expert; early-fusion multimodal (the vision frontend is
out of scope for the LM backbone — text path only here, per assignment).
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attention="gqa",
    rope_theta=500_000.0,
    num_experts=16,
    num_shared_experts=1,
    moe_top_k=1,
    moe_d_ff=8192,
)
