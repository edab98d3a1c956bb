"""Granite 3 8B. [hf:ibm-granite/granite-3.0-2b-base family, 8B variant]

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    arch_type="dense",
    citation="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    rope_theta=1e4,
    param_dtype="bfloat16",
    grad_accum=2,
)
