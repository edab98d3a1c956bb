"""Decoder-only language model assembly (dense / moe / vlm / hybrid /
ssm), the train path of ``repro.models.lm``.

Parameters are the reference's stacked tree — every per-layer leaf has
a leading ``(L, …)`` dim under ``params["layers"]`` (xLSTM: ``L/2``
(mLSTM, sLSTM) pairs) — so frame leaf names and block layouts match.
The reference's ``lax.scan`` over layers is a Python loop over that
dim, and its per-layer ``jax.checkpoint`` is ``torch.utils.checkpoint``
(``cfg.remat``). Hybrid (Hymba) layers take their attention window from
``layer_windows``. The decode caches are not ported yet.

Batch dict: {"tokens": (B,S) int32, "targets": (B,S) int32,
             ["patch_embeds": (B,P,Fd), "loss_mask": (B,S) f32]}.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, moe as moe_lib, ops, xlstm
from repro_torch.models.param import ParamSpec


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------

def layer_specs(cfg: ArchConfig, layers: Optional[int] = None) -> dict:
    L = layers if layers is not None else cfg.n_layers
    t = cfg.arch_type
    if t == "ssm":  # xLSTM: (mLSTM, sLSTM) pairs
        assert cfg.slstm_every == 2 and L % 2 == 0
        return {"mlstm": xlstm.mlstm_specs(cfg, L // 2),
                "slstm": xlstm.slstm_specs(cfg, L // 2)}
    specs = {
        "attn_norm": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="ones"),
        "attn": blocks.attention_specs(cfg, L),
        "ffn_norm": ParamSpec((L, cfg.d_model), ("layers", "embed"), init="ones"),
    }
    if t == "moe":
        specs["moe"] = moe_lib.moe_specs(cfg, L)
    else:
        specs["ffn"] = blocks.ffn_specs(cfg, L)
    if t == "hybrid":
        specs["mamba"] = blocks.mamba_specs(cfg, L)
    return specs


def param_specs(cfg: ArchConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab
    specs: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), init="embed", scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "layers": layer_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
    if cfg.arch_type == "vlm":
        specs["projector"] = ParamSpec((cfg.frontend_dim, d), ("null", "embed"))
    return specs


# --------------------------------------------------------------------------
# Per-layer window pattern (hybrid archs)
# --------------------------------------------------------------------------

def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """window per layer; 0 = full attention."""
    w = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    for i in cfg.global_attn_layers:
        w[i] = 0
    return w


# --------------------------------------------------------------------------
# Forward (train / prefill)
# --------------------------------------------------------------------------

def _std_block(lp, h, cfg: ArchConfig, positions, window: int):
    """One dense/moe/vlm/hybrid block. Returns (h, aux); aux is the MoE
    router's loss, None for the other families."""
    x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    attn_out = blocks.attention_apply(lp["attn"], x, cfg,
                                      positions=positions, window=window)
    if cfg.arch_type == "hybrid":
        m_out = blocks.mamba_apply(lp["mamba"], x, cfg)
        attn_out = 0.5 * (attn_out + m_out)
    h = h + attn_out
    x = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    if cfg.arch_type == "moe":
        f_out, aux = moe_lib.moe_apply(lp["moe"], x, cfg)
    else:
        f_out, aux = blocks.ffn_apply(lp["ffn"], x), None
    return h + f_out, aux


def _ssm_pair(lp, h, cfg: ArchConfig):
    h = xlstm.mlstm_apply(lp["mlstm"], h, cfg)
    return xlstm.slstm_apply(lp["slstm"], h, cfg)


def _layer(layers, i: int):
    """Slice layer ``i`` out of the stacked per-layer tree."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def _run(fn, cfg: ArchConfig, *args):
    """``fn(*args)``, recomputed on backward when ``cfg.remat`` is set."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def stack_apply(params, h, cfg: ArchConfig, positions):
    """Run the layer stack (the reference scans it). Returns (h, aux_sum);
    aux_sum is 0 without MoE layers."""
    aux = []
    if cfg.arch_type == "ssm":
        for i in range(cfg.n_layers // 2):
            h = _run(_ssm_pair, cfg, _layer(params["layers"], i), h, cfg)
    else:
        windows = layer_windows(cfg).tolist()
        for i in range(cfg.n_layers):
            h, a = _run(_std_block, cfg, _layer(params["layers"], i), h,
                        cfg, positions, int(windows[i]))
            if a is not None:
                aux.append(a)
    if not aux:
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    return h, torch.stack(aux).sum()


def embed_tokens(params, batch, cfg: ArchConfig):
    tokens = batch["tokens"]
    scale = ops.sqrt_scale(cfg.d_model, cfg.cdtype())
    h = params["embed"].to(cfg.cdtype())[tokens.long()] * scale
    if cfg.arch_type == "vlm":
        pe = torch.matmul(batch["patch_embeds"].to(cfg.cdtype()),
                          params["projector"].to(cfg.cdtype())) * scale
        P, S = pe.shape[1], h.shape[1]
        h = torch.cat([pe, h[:, P:]], dim=1) if P < S else pe[:, :S]
    return h


def lm_head_weight(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def forward(params, batch, cfg: ArchConfig):
    """Full-sequence forward to final hidden states (B, S, d) and the
    summed router aux loss."""
    h = embed_tokens(params, batch, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    h, aux = stack_apply(params, h, cfg, positions)
    return ops.rms_norm(h, params["final_norm"], cfg.norm_eps), aux


def loss_fn(params, batch, cfg: ArchConfig):
    """Mean next-token cross-entropy (+ MoE aux). Returns (loss, metrics)."""
    h, aux = forward(params, batch, cfg)
    tot, cnt = ops.chunked_softmax_xent(
        h, lm_head_weight(params, cfg), batch["targets"],
        chunk=cfg.loss_chunk, mask=batch.get("loss_mask"), remat=cfg.remat)
    xent = tot / torch.clamp(cnt, min=1.0)
    loss = xent + cfg.moe.router_aux_weight * aux
    return loss, {"xent": xent, "aux": aux, "tokens": cnt}
