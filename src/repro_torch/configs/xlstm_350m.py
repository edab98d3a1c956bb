"""xLSTM 350M. [arXiv:2405.04517]

24 blocks d_model=1024 4H d_ff=0 (projections live inside the blocks)
vocab=50304. Alternating sLSTM + mLSTM blocks (every 2nd block sLSTM).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    arch_type="ssm",
    citation="arXiv:2405.04517",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    ssm=SSMConfig(state_dim=0, conv_width=4, expand=2, chunk=128),
    slstm_every=2,
)
