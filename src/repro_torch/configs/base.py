"""Architecture + input-shape configuration system.

Every ported architecture is a frozen ``ArchConfig`` built by a
``configs/<id>.py`` module (one per arch, citing its source).
``ShapeConfig`` describes the four assigned input shapes. Both are plain
dataclasses so they can be constructed / overridden from the CLI
(``--arch``, ``--shape``) and reduced for CPU smoke tests via
``reduced()``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


#: config dtype strings -> torch dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared: int = 0             # always-on shared experts (DeepSeekMoE)
    expert_ff: int = 0            # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16           # mamba N / mLSTM matrix-memory per-head dim
    conv_width: int = 4
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 128              # chunkwise-scan chunk length


@dataclass(frozen=True)
class ArchConfig:
    name: str = "unnamed"
    arch_type: str = "dense"      # dense | moe | ssm | hybrid | audio | vlm
    citation: str = ""

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 32000
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention variants
    sliding_window: int = 0                 # 0 = full attention
    # per-layer window pattern used by hybrid archs ("hymba keeps a few
    # global layers"); empty = uniform.
    global_attn_layers: Tuple[int, ...] = ()

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # encoder-decoder (audio backbone): n_layers is the decoder depth.
    n_encoder_layers: int = 0
    # vlm: dimensionality of the (stubbed) vision/audio frontend embeddings.
    frontend_dim: int = 0
    n_patches: int = 0            # patches (vlm) / frames divisor (audio)

    # precision / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    grad_accum: int = 1           # microbatches inside train_step
    # dtype of the accumulated-gradient buffer; bf16 halves the FSDP
    # reduce-scatter traffic and the accumulator footprint (§Perf B-1)
    grad_accum_dtype: str = "float32"
    loss_chunk: int = 512         # seq chunk for the chunked softmax-xent

    # xlstm: every `slstm_every`-th block is an sLSTM block (rest mLSTM)
    slstm_every: int = 2

    # per-arch logical->mesh rule overrides, as ((logical, axes), ...)
    # where axes is a mesh-axis name, a tuple of names, or None. Applied
    # to TRAINING steps only — serving keeps the default (TP/seq-sharded
    # cache) layout, which is the right trade-off for small-batch decode.
    sharding_overrides: Tuple = ()

    def rules(self, kind: str = "train") -> dict:
        if kind != "train":
            return {}
        return {k: v for k, v in self.sharding_overrides}

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """CPU-smoke-test variant: <=2 layers, d_model<=256, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        moe = self.moe
        if moe.n_experts:
            # drop-free capacity (C >= T needs cf >= E/K) so that decode
            # (per-token capacity) matches prefill bit-for-bit in tests
            k = min(2, moe.top_k)
            moe = dataclasses.replace(
                moe, n_experts=4, top_k=k,
                n_shared=min(1, moe.n_shared), expert_ff=max(64, d // 2),
                capacity_factor=4.0 / k + 0.5)
        return self.replace(
            n_layers=2, d_model=d, n_heads=heads, n_kv_heads=kv,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab=min(self.vocab, 512), head_dim=0, moe=moe,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            frontend_dim=min(self.frontend_dim, 128) if self.frontend_dim else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            global_attn_layers=tuple(i for i in self.global_attn_layers if i < 2),
            ssm=dataclasses.replace(self.ssm, chunk=16),
            param_dtype="float32", compute_dtype="float32",
            grad_accum=1, loss_chunk=64,
        )

    # ---- simple parameter counting (used by roofline MODEL_FLOPS) ----
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd()
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
        o = self.n_heads * hd * d
        attn = qkv + o
        if self.arch_type == "moe":
            ff = 3 * d * self.moe.expert_ff * (self.moe.n_experts + self.moe.n_shared)
            ff += d * self.moe.n_experts  # router
        elif self.arch_type == "ssm":
            di = self.ssm.expand * d
            ff = 2 * d * di + di * d  # up/gate + down per block (approx)
            attn = 0
        else:
            ff = 3 * d * self.d_ff
        if self.arch_type == "hybrid":
            di = self.ssm.expand * d
            attn += 2 * d * di + di * d + di * self.ssm.state_dim * 2
        per_layer = attn + ff + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        n = self.n_layers * per_layer + emb + d
        if self.n_encoder_layers:
            n += self.n_encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
            n += self.n_layers * (attn + 2 * d)  # cross-attention
        if self.frontend_dim:
            n += self.frontend_dim * d
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.arch_type != "moe":
            return self.param_count()
        d = self.d_model
        m = self.moe
        dense_like = self.param_count() - self.n_layers * 3 * d * m.expert_ff * m.n_experts
        return dense_like + self.n_layers * 3 * d * m.expert_ff * m.top_k


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
