"""Block-level mixers of the dense decoder: GQA attention and the
SwiGLU FFN (the reference's ``repro.models.blocks``, dense train path
only — no decode caches, no Mamba mixer). ``distributed.sharding.shard``
constraints of the reference are the identity on one device."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ops
from repro_torch.models.param import ParamSpec


# --------------------------------------------------------------------------
# GQA attention mixer
# --------------------------------------------------------------------------

def attention_specs(cfg: ArchConfig, layers: int) -> dict:
    d, hd = cfg.d_model, cfg.hd()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    L = (layers,)
    specs = {
        "wq": ParamSpec(L + (d, H * hd), ("layers", "fsdp", "heads")),
        "wk": ParamSpec(L + (d, KV * hd), ("layers", "fsdp", "kv_heads")),
        "wv": ParamSpec(L + (d, KV * hd), ("layers", "fsdp", "kv_heads")),
        "wo": ParamSpec(L + (H * hd, d), ("layers", "heads", "fsdp")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec(L + (H * hd,), ("layers", "heads"), init="zeros")
        specs["bk"] = ParamSpec(L + (KV * hd,), ("layers", "kv_heads"), init="zeros")
        specs["bv"] = ParamSpec(L + (KV * hd,), ("layers", "kv_heads"), init="zeros")
    return specs


def _qkv(p, x, cfg: ArchConfig, positions):
    B, S, d = x.shape
    hd, H, KV = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    q = torch.matmul(x, p["wq"].to(x.dtype))
    k = torch.matmul(x, p["wk"].to(x.dtype))
    v = torch.matmul(x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if positions is not None:
        q = ops.apply_rope(q, positions, cfg.rope_theta)
        k = ops.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(p, x, cfg: ArchConfig, *, positions, causal=True,
                    window=0):
    """Full-sequence causal self-attention."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    out = ops.attention(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, -1)
    return torch.matmul(out, p["wo"].to(x.dtype))


# --------------------------------------------------------------------------
# Dense SwiGLU FFN
# --------------------------------------------------------------------------

def ffn_specs(cfg: ArchConfig, layers: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    L = (layers,)
    return {
        "wg": ParamSpec(L + (d, f), ("layers", "fsdp", "mlp")),
        "wu": ParamSpec(L + (d, f), ("layers", "fsdp", "mlp")),
        "wd": ParamSpec(L + (f, d), ("layers", "mlp", "fsdp")),
    }


def ffn_apply(p, x):
    return ops.swiglu(x, p["wg"], p["wu"], p["wd"])
