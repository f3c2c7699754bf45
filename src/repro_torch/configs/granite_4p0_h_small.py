"""Granite 4.0-H Small (32B total, ~9B active): Mamba-2 and attention
layers in one stack, each with a mixture of experts.

From the published ``config.json`` (huggingface.co/ibm-granite/
granite-4.0-h-small): 40 layers of d 4096, 36 Mamba-2 mixers (128 heads
of P 64, state N 128, one group, conv 4, chunk 256, expand 2) and 4 NoPE
GQA mixers (32 query and 8 KV heads of 128, at layers 5, 15, 25 and 35);
every layer's feed-forward is 72 routed SwiGLU experts of 768, top-10,
plus one shared SwiGLU of 1536; vocab 100352, tied embeddings, RMSNorm
eps 1e-5. Its scalars: the embedded tokens times 12, each block's output
times 0.22 before the residual add, the softmax scale 1/128, the logits
divided by 16. The router is a softmax over the top-10 logits, which is
the port's softmax, top-k and renormalise.
"""

from repro_torch.configs import ArchConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = ArchConfig(
    arch_id="granite-4.0-h-small",
    family="hybrid",
    source="huggingface.co/ibm-granite/granite-4.0-h-small config.json",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=100352,
    attention="gqa",
    max_seq_len=131072,
    rope_theta=10000.0,
    num_experts=72,
    num_shared_experts=1,
    moe_top_k=10,
    moe_d_ff=768,
    # 72 / 10: every expert has a place for every token of a batch, so no
    # token is dropped, as in the published model's inference
    capacity_factor=7.2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=256,
    ssm_conv_width=4,
    tie_embeddings=True,
    layer_types=_PERIOD * 4,
    use_rope=False,
    attn_scale=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    shared_d_ff=1536,
)
