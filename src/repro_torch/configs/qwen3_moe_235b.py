"""Qwen3-MoE 235B-A22B backbone. [hf:Qwen/Qwen3-30B-A3B scaled per assignment]

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    citation="hf:Qwen/Qwen3-30B-A3B",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,  # qwen3 uses 128 head_dim (64 heads x 128 > d_model)
    moe=MoEConfig(n_experts=128, top_k=8, n_shared=0, expert_ff=1536,
                  capacity_factor=1.25),
    rope_theta=1e6,
    param_dtype="bfloat16",
    grad_accum=4,
    grad_accum_dtype="bfloat16",
)
