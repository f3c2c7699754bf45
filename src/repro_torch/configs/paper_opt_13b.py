"""OPT-13B — the paper's own serving-comparison model family [arXiv:2205.01068].

The paper's Fig. 9 benchmarks ORCA/vLLM on OPT models; we include OPT-13B as
the paper-faithful config used by the serving benchmarks.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="paper-opt-13b",
    family="dense",
    source="arXiv:2205.01068",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=20480,
    vocab_size=50272,
    attention="gqa",
    max_seq_len=2048,
    use_bias=True,
    gated_mlp=False,
    tie_embeddings=True,
)
