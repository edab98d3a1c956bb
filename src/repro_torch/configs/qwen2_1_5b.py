"""Qwen2 1.5B. [arXiv:2407.10671]

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    citation="arXiv:2407.10671",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    param_dtype="bfloat16",
    # §Perf C-1: 12 heads don't divide a 16-way model axis, so tensor
    # parallelism degenerates (attention replicated 16x). A 1.5B model
    # fits per-chip: run pure 256-way data parallel with FSDP over the
    # whole mesh instead.
    sharding_overrides=(
        ("batch", ("pod", "data", "model")),
        ("fsdp", ("pod", "data", "model")),
        ("heads", None), ("mlp", None), ("vocab", None),
    ),
)
