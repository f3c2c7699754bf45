"""H2O-Danube 1.8B — llama+mistral mix with sliding-window attention [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    attention="gqa",
    sliding_window=4096,
    max_seq_len=16384,
)
