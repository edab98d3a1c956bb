"""Block-level mixers shared by the model zoo (the reference's
``repro.models.blocks``, train path): GQA attention (self- and, with
``kv=``, cross-attention), the SwiGLU FFN and Hymba's Mamba-2 style
selective-SSM mixer. The decode halves (caches) are not ported yet.
``distributed.sharding.shard`` constraints of the reference are the
identity on one device."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import linear_attn as la
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


def _proj(p, x, cfg: ArchConfig, name: str, heads: int, positions):
    """One of q/k/v: ``x @ w<name>`` (+ bias), split into heads, rotated
    when ``positions`` is given (v never is)."""
    B, S, _ = x.shape
    y = torch.matmul(x, p["w" + name].to(x.dtype))
    if cfg.qkv_bias:
        y = y + p["b" + name].to(x.dtype)
    y = y.reshape(B, S, heads, cfg.hd())
    if positions is not None and name != "v":
        y = ops.apply_rope(y, positions, cfg.rope_theta)
    return y


def _qkv(p, x, cfg: ArchConfig, positions):
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return (_proj(p, x, cfg, "q", H, positions),
            _proj(p, x, cfg, "k", KV, positions),
            _proj(p, x, cfg, "v", KV, positions))


def attention_apply(p, x, cfg: ArchConfig, *, positions, causal=True,
                    window=0, kv: Optional[tuple] = None):
    """Full-sequence attention. ``kv`` overrides keys/values
    (cross-attention): q is rotated, the given k/v are taken as they are
    and the attention is not causal. The reference also projects k/v
    from ``x`` and drops them (XLA removes that work); here they are not
    computed."""
    B, S, _ = x.shape
    if kv is None:
        q, k, v = _qkv(p, x, cfg, positions)
    else:
        q = _proj(p, x, cfg, "q", cfg.n_heads, positions)
        (k, v), causal = kv, False
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


# --------------------------------------------------------------------------
# Mamba-2 style selective-SSM mixer (Hymba's parallel SSM heads)
# --------------------------------------------------------------------------

def _causal_conv(x, kernel):
    """Depthwise causal conv. x: (B,S,C); kernel: (W,C). Accumulates in
    f32, tap by tap, and returns x's dtype."""
    W = kernel.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    S = x.shape[1]
    for j in range(W):
        out = out + kernel[j].float() * xp[:, j:j + S].float()
    return out.to(x.dtype)


def _mamba_dims(cfg: ArchConfig):
    di = cfg.ssm.expand * cfg.d_model
    Hm = max(1, di // 64)
    return di, cfg.ssm.state_dim, Hm, di // Hm


def mamba_specs(cfg: ArchConfig, layers: int) -> dict:
    d = cfg.d_model
    di, N, Hm, _ = _mamba_dims(cfg)
    L = (layers,)
    return {
        "wx": ParamSpec(L + (d, di), ("layers", "fsdp", "mlp")),
        "wz": ParamSpec(L + (d, di), ("layers", "fsdp", "mlp")),
        "wB": ParamSpec(L + (d, N), ("layers", "fsdp", "state")),
        "wC": ParamSpec(L + (d, N), ("layers", "fsdp", "state")),
        "wdt": ParamSpec(L + (d, Hm), ("layers", "fsdp", "heads")),
        "dt_bias": ParamSpec(L + (Hm,), ("layers", "heads"), init="zeros"),
        "A_log": ParamSpec(L + (Hm,), ("layers", "heads"), init="zeros"),
        "Dskip": ParamSpec(L + (Hm,), ("layers", "heads"), init="ones"),
        "conv": ParamSpec(L + (cfg.ssm.conv_width, di), ("layers", "conv", "mlp"),
                          init="normal", scale=0.5),
        "wout": ParamSpec(L + (di, d), ("layers", "mlp", "fsdp")),
    }


def _mamba_qkv(p, x, cfg: ArchConfig):
    di, N, Hm, hp = _mamba_dims(cfg)
    xm = torch.matmul(x, p["wx"].to(x.dtype))
    z = torch.matmul(x, p["wz"].to(x.dtype))
    return xm, z, di, N, Hm, hp


def mamba_apply(p, x, cfg: ArchConfig):
    B, S, d = x.shape
    xm, z, di, N, Hm, hp = _mamba_qkv(p, x, cfg)
    xm = F.silu(_causal_conv(xm, p["conv"]).float()).to(x.dtype)
    Bm = torch.matmul(x, p["wB"].to(x.dtype))
    Cm = torch.matmul(x, p["wC"].to(x.dtype))
    dt = F.softplus(torch.matmul(x, p["wdt"].to(x.dtype)).float()
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                  # (Hm,)
    ld = dt * A                                         # (B,S,Hm) <= 0
    q = Cm[:, :, None, :].expand(B, S, Hm, N)
    k = Bm[:, :, None, :].expand(B, S, Hm, N)
    v = xm.reshape(B, S, Hm, hp) * dt[..., None].to(x.dtype)
    y = la.chunked(q, k, v, ld, chunk=cfg.ssm.chunk)
    y = y + xm.reshape(B, S, Hm, hp) * p["Dskip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, di) * F.silu(z.float()).to(x.dtype)
    return torch.matmul(y, p["wout"].to(x.dtype))
