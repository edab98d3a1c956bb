"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1),
without a query compression, full-sequence (train/prefill) only.

For one layer, with ``cfg.mla`` = (r, dn, dr, dv):

* ``q = x W_q``, per head a part without position ``q_nope`` (dn) and a
  rotated part ``q_pe`` (dr);
* ``[c_kv, k_pe] = x W_kva`` (widths r and dr), ``c_kv = RMSNorm(c_kv)``;
* ``[k_nope, v] = c_kv W_kvb``, per head dn and dv;
* ``q_pe`` and the one ``k_pe`` head, shared by every head, are rotated
  (YaRN where ``cfg.rope_scaling`` is set; halves, as the port's other
  rotations, where the published code rotates interleaved pairs);
* causal softmax attention of ``q = [q_nope, q_pe]`` against
  ``k = [k_nope, k_pe]`` at scale ``(dn + dr)^-1/2 * m^2`` (``m`` YaRN's
  magnitude of ``mscale_all_dim``), values ``v``; ``out = attn W_o``.

Each call is an ``attn.mla`` span on the card's clock when tracing is
on (under ``remat`` the recompute in backward opens one too). The
reference computes no MLA, so there is no decode path here: the model's
``init_cache`` and ``decode_step`` raise for it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ops
from repro_torch.models.param import ParamSpec
from repro_torch.obs.trace import trace_span


def mla_specs(cfg: ArchConfig, layers: int) -> dict:
    d, H, a = cfg.d_model, cfg.n_heads, cfg.mla
    r = a.kv_lora_rank
    L = (layers,)
    return {
        "wq": ParamSpec(L + (d, H * a.qk_dim()), ("layers", "fsdp", "heads")),
        "wkv_a": ParamSpec(L + (d, r + a.qk_rope_head_dim),
                           ("layers", "fsdp", None)),
        "kv_norm": ParamSpec(L + (r,), ("layers", None), init="ones"),
        "wkv_b": ParamSpec(L + (r, H * (a.qk_nope_head_dim + a.v_head_dim)),
                           ("layers", None, "heads")),
        "wo": ParamSpec(L + (H * a.v_head_dim, d), ("layers", "heads", "fsdp")),
    }


def softmax_scale(cfg: ArchConfig) -> float:
    """``(dn + dr)^-1/2``, times ``m^2`` under YaRN with an
    ``mscale_all_dim``."""
    scale = cfg.mla.qk_dim() ** -0.5
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        m = ops.yarn_mscale(y.factor, y.mscale_all_dim)
        scale = scale * m * m
    return scale


def mla_apply(p, x, cfg: ArchConfig, *, positions):
    """x: (B, S, d) -> (B, S, d), causal."""
    with trace_span("attn.mla", "model", device=True):
        B, S, _ = x.shape
        a, H = cfg.mla, cfg.n_heads
        dn, dr, dv = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
        q = torch.matmul(x, p["wq"].to(x.dtype)).reshape(B, S, H, dn + dr)
        q_nope, q_pe = torch.split(q, [dn, dr], dim=-1)
        kva = torch.matmul(x, p["wkv_a"].to(x.dtype))
        c_kv, k_pe = torch.split(kva, [a.kv_lora_rank, dr], dim=-1)
        c_kv = ops.rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
        kv = torch.matmul(c_kv, p["wkv_b"].to(x.dtype)).reshape(
            B, S, H, dn + dv)
        k_nope, v = torch.split(kv, [dn, dv], dim=-1)
        q_pe = ops.apply_rope(q_pe, positions, cfg.rope_theta,
                              cfg.rope_scaling)
        k_pe = ops.apply_rope(k_pe[:, :, None], positions, cfg.rope_theta,
                              cfg.rope_scaling)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, S, H, dr)], dim=-1)
        out = ops.attention(q, k, v, causal=True, scale=softmax_scale(cfg))
        return torch.matmul(out.reshape(B, S, H * dv), p["wo"].to(x.dtype))
