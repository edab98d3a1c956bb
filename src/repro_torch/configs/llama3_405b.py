"""Llama-3.1 405B. [arXiv:2407.21783]

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    arch_type="dense",
    citation="arXiv:2407.21783",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
    param_dtype="bfloat16",
    # §Perf B-1: 8 microbatches (half the per-step FSDP weight-gather
    # rounds; activation stash stays within HBM thanks to the
    # sequence-parallel residual) + bf16 gradient accumulation (halves
    # reduce-scatter traffic and the accumulator footprint).
    grad_accum=4,
    grad_accum_dtype="bfloat16",
    loss_chunk=256,
)
