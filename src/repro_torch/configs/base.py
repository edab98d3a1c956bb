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
    # port-only: False keeps the top-k softmax gates as they are (their
    # sum under 1); the reference always renormalises them
    norm_topk: bool = True
    # port-only: this card's share of the routed experts, 0..held-1
    # (0 = all of them); the router and the capacity still count all
    # ``n_experts``
    held_experts: int = 0

    def held(self) -> int:
        return self.held_experts or self.n_experts


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16           # mamba N / mLSTM matrix-memory per-head dim
    conv_width: int = 4
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 128              # chunkwise-scan chunk length


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 §2.1) without a query
    compression: keys and values come from one latent of width
    ``kv_lora_rank`` per token; each head's query and key are a part
    without position (``qk_nope_head_dim``) and a rotated part
    (``qk_rope_head_dim``, one key head shared by every head)."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    def qk_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class YarnScaling:
    """YaRN rotary scaling (Peng et al. 2023, as DeepSeek-V2 sets it):
    frequencies past the correction range divided by ``factor``, a linear
    ramp between, and the attention scale multiplied by the square of
    ``0.1 * mscale_all_dim * ln(factor) + 1``."""
    factor: float = 40.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


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

    # port-only (the reference has none of these): latent attention in
    # place of GQA, YaRN rotary scaling, and leading layers whose FFN is
    # a dense SwiGLU of width ``d_ff`` in an MoE model (their leaves are
    # the ``dense_layers`` stack)
    mla: Optional[MLAConfig] = None
    rope_scaling: Optional[YarnScaling] = None
    first_dense_layers: int = 0

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
                capacity_factor=4.0 / k + 0.5,
                held_experts=(max(1, 4 * moe.held_experts // moe.n_experts)
                              if moe.held_experts else 0))
        mla = self.mla and dataclasses.replace(
            self.mla, kv_lora_rank=min(self.mla.kv_lora_rank, 64),
            qk_nope_head_dim=min(self.mla.qk_nope_head_dim, 32),
            qk_rope_head_dim=min(self.mla.qk_rope_head_dim, 16),
            v_head_dim=min(self.mla.v_head_dim, 32))
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
            mla=mla, first_dense_layers=min(self.first_dense_layers, 1),
        )

    # ---- simple parameter counting (used by roofline MODEL_FLOPS) ----
    def attn_param_count(self) -> int:
        """One layer's attention mixer (no biases)."""
        d, H = self.d_model, self.n_heads
        if self.mla is not None:
            a = self.mla
            return (d * H * a.qk_dim()
                    + d * (a.kv_lora_rank + a.qk_rope_head_dim)
                    + a.kv_lora_rank
                    + a.kv_lora_rank * H * (a.qk_nope_head_dim + a.v_head_dim)
                    + H * a.v_head_dim * d)
        hd = self.hd()
        qkv = d * (H * hd) + 2 * d * (self.n_kv_heads * hd)
        return qkv + H * hd * d

    def param_count(self) -> int:
        d = self.d_model
        attn = self.attn_param_count()
        if self.arch_type == "moe":
            ff = 3 * d * self.moe.expert_ff * (self.moe.held() + self.moe.n_shared)
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
        # leading layers with a dense SwiGLU in place of the experts
        n += self.first_dense_layers * (3 * d * self.d_ff - ff)
        if self.n_encoder_layers:
            n += self.n_encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
            n += self.n_layers * (attn + 2 * d)  # cross-attention
        if self.frontend_dim:
            n += self.frontend_dim * d
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared; of
        held experts, the expected top_k * held / n_experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        d = self.d_model
        m = self.moe
        L = self.n_layers - self.first_dense_layers
        dense_like = self.param_count() - L * 3 * d * m.expert_ff * m.held()
        return dense_like + L * 3 * d * m.expert_ff * m.top_k * m.held() \
            // m.n_experts


#: the port-only fields of ``ArchConfig`` and of its ``MoEConfig``, with
#: the values at which the port computes what the reference computes
PORT_FIELDS = {"mla": None, "rope_scaling": None, "first_dense_layers": 0}
PORT_MOE_FIELDS = {"norm_topk": True, "held_experts": 0}


def reference_fields(cfg: ArchConfig) -> dict:
    """``dataclasses.asdict(cfg)`` in the reference's terms: the port-only
    fields left out where they hold those values, and kept otherwise, so
    that such a config never equals one of the reference's."""
    out = dataclasses.asdict(cfg)
    for fields, d in ((PORT_FIELDS, out), (PORT_MOE_FIELDS, out["moe"])):
        for k, v in fields.items():
            if d[k] == v:
                del d[k]
    return out


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
