"""Pixtral 12B language backbone. [hf:mistralai/Pixtral-12B-2409]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The Pixtral-ViT
vision tower is a STUB: ``input_specs`` supplies precomputed patch
embeddings (B, n_patches, 1024) that the trainable projector maps into
the decoder's embedding stream.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    arch_type="vlm",
    citation="hf:mistralai/Pixtral-12B-2409",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    frontend_dim=1024,
    n_patches=1024,
    rope_theta=1e6,
    param_dtype="bfloat16",
    grad_accum=2,
)
