"""DeepSeek-V2-Lite. [hf:deepseek-ai/DeepSeek-V2-Lite config.json;
arXiv:2405.04434 §2.1 for multi-head latent attention]

27L d_model=2048 16H vocab=102400, RMSNorm eps 1e-6. Attention is MLA
without a query compression (``q_lora_rank`` null): a key-value latent
of 512, per head 128 query/key dims without position, 64 rotated (one
key head shared by all heads) and 128 value dims; YaRN rope (theta 1e4,
factor 40 over an original 4096 positions, beta_fast 32, beta_slow 1,
mscale = mscale_all_dim = 0.707). Layer 0 is a dense SwiGLU of width
10944 (``first_k_dense_replace`` 1); layers 1-26 hold 64 routed experts
of width 1408, top-6 of a softmax router without renormalising the
gates (``norm_topk_prob`` false, ``routed_scaling_factor`` 1), and 2
shared experts.

Departures from the published model:

* rope pairs: the published code rotates interleaved pairs of the 64
  rotated dims; the port rotates halves, as its other models do. That
  equals the published rotation up to a fixed permutation of those
  weight columns.
* capacity: factor 1.25; the published config gives none (it drops no
  assignment).
* aux loss: the router's load-balance weight is not in the published
  config; 0.001 (DeepSeek-V2's expert-level alpha_1). With one sequence
  a micro-batch the port's Switch term equals DeepSeek-V2's sequence-wise
  one.

Only the port has this entry (``PORT_ONLY``): the reference registry has
no MLA, no leading dense layer and no un-renormalised gates. Decode is
not ported for MLA.
"""
from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      YarnScaling)

CONFIG = ArchConfig(
    name="deepseek-v2-lite",
    arch_type="moe",
    citation="hf:deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab=102400,
    norm_eps=1e-6,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_ff=1408,
                  capacity_factor=1.25, router_aux_weight=0.001,
                  norm_topk=False),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    rope_theta=1e4,
    rope_scaling=YarnScaling(factor=40.0, original_max_position=4096,
                             beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                             mscale_all_dim=0.707),
    first_dense_layers=1,
    param_dtype="bfloat16",
    grad_accum=2,
)
