"""StableLM 2 1.6B. [hf:stabilityai/stablelm-2-1_6b]

24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    citation="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    rope_theta=1e4,
)
