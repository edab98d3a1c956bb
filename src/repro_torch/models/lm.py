"""Decoder-only language model assembly (dense path of ``repro.models.lm``).

Parameters are the reference's stacked tree — every per-layer leaf has
a leading ``(L, …)`` dim under ``params["layers"]`` — so frame leaf
names and block layouts match. The reference's ``lax.scan`` over layers
is a Python loop over that dim, and its per-layer ``jax.checkpoint`` is
``torch.utils.checkpoint`` (``cfg.remat``).

Batch dict: {"tokens": (B,S) int32, "targets": (B,S) int32}.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, ops
from repro_torch.models.param import ParamSpec


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------

def _check_dense(cfg: ArchConfig) -> None:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"only dense decoder LMs are ported (got {cfg.arch_type!r})")


def layer_specs(cfg: ArchConfig, layers: Optional[int] = None) -> dict:
    _check_dense(cfg)
    L = layers if layers is not None else cfg.n_layers
    return {
        "attn_norm": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="ones"),
        "attn": blocks.attention_specs(cfg, L),
        "ffn_norm": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="ones"),
        "ffn": blocks.ffn_specs(cfg, L),
    }


def param_specs(cfg: ArchConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab
    specs: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), init="embed", scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "layers": layer_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
    return specs


# --------------------------------------------------------------------------
# Forward (train / prefill)
# --------------------------------------------------------------------------

def _std_block(lp, h, cfg: ArchConfig, positions, window: int):
    """One dense block."""
    x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + blocks.attention_apply(lp["attn"], x, cfg, positions=positions,
                                   window=window)
    x = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + blocks.ffn_apply(lp["ffn"], x)


def _layer(layers, i: int):
    """Slice layer ``i`` out of the stacked per-layer tree."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def stack_apply(params, h, cfg: ArchConfig, positions):
    """Run the layer stack (the reference scans it). Returns h."""
    window = int(cfg.sliding_window)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(_std_block, lp, h, cfg, positions, window,
                           use_reentrant=False)
        else:
            h = _std_block(lp, h, cfg, positions, window)
    return h


def embed_tokens(params, batch, cfg: ArchConfig):
    tokens = batch["tokens"]
    h = params["embed"].to(cfg.cdtype())[tokens.long()]
    return h * ops.sqrt_scale(cfg.d_model, cfg.cdtype())


def lm_head_weight(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def forward(params, batch, cfg: ArchConfig):
    """Full-sequence forward to final hidden states (B, S, d)."""
    h = embed_tokens(params, batch, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    h = stack_apply(params, h, cfg, positions)
    return ops.rms_norm(h, params["final_norm"], cfg.norm_eps)


def loss_fn(params, batch, cfg: ArchConfig):
    """Mean next-token cross-entropy. Returns (loss, metrics)."""
    h = forward(params, batch, cfg)
    tot, cnt = ops.chunked_softmax_xent(
        h, lm_head_weight(params, cfg), batch["targets"],
        chunk=cfg.loss_chunk, mask=batch.get("loss_mask"), remat=cfg.remat)
    xent = tot / torch.clamp(cnt, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return xent, {"xent": xent, "aux": aux, "tokens": cnt}
