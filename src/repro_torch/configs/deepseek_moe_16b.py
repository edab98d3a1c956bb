"""DeepSeekMoE 16B. [arXiv:2401.06066]

28L d_model=2048 16H (MHA kv=16) per-expert d_ff=1408 vocab=102400,
MoE: 2 shared + 64 routed experts, top-6 (fine-grained experts).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    citation="arXiv:2401.06066",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_ff=1408,
                  capacity_factor=1.25),
    rope_theta=1e4,
    param_dtype="bfloat16",
    grad_accum=2,
)
