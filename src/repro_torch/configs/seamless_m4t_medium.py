"""SeamlessM4T-medium transformer backbone. [arXiv:2308.11596]

Encoder-decoder, 12L encoder + 12L decoder, d_model=1024 16H (MHA)
d_ff=4096 vocab=256206. The mel-spectrogram/conformer frontend is a STUB:
``input_specs`` supplies precomputed frame embeddings (B, S/4, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    citation="arXiv:2308.11596",
    n_layers=12,
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    frontend_dim=1024,
    rope_theta=1e4,
)
