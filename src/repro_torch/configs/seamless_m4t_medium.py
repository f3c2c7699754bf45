"""SeamlessM4T-medium — enc-dec multimodal translation [arXiv:2308.11596].

12L(enc) + 12L(dec) d_model=1024 16H d_ff=4096 vocab=256206. The speech
frontend (mel-spectrogram + conv feature extractor) is a STUB per the
assignment carve-out: ``input_specs`` provides precomputed frame embeddings;
this config is the text/unit transformer backbone.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    attention="gqa",
    use_bias=True,
    gated_mlp=False,
    frontend="audio",
    num_media_tokens=512,  # precomputed speech-frame embeddings fed to the encoder
)
