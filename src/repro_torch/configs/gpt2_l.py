"""GPT2-L — the paper's own largest evaluation model. [Radford'19]

36L d_model=1280 20H d_ff=5120 vocab=50257, with the repo's SwiGLU FFN,
RoPE and RMSNorm: 1,072,469,760 parameters as ``param_count()`` counts
them (GPT-2's own GELU MLP would give 762M). The port's main path.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gpt2-l",
    arch_type="dense",
    citation="Radford et al. 2019 (paper's Table II)",
    n_layers=36,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=50257,
    rope_theta=1e4,
)
