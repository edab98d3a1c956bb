"""Hymba 1.5B. [arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Parallel attention + mamba heads in every block; sliding-window attention
everywhere except the first / middle / last layers (full attention).
Meta tokens from the paper are omitted, as in the reference.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    citation="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, chunk=128),
)
