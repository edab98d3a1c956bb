"""Encoder-decoder backbone (SeamlessM4T-medium assignment), the train
path of ``repro.models.encdec``.

The audio frontend (mel-spectrogram + conformer feature extractor) is a
stub, as in the reference: the batch carries precomputed frame
embeddings ``src_embeds`` (B, S_src, d_model). The transformer encoder
(non-causal, rotating its own positions) runs over those frames and the
causal decoder cross-attends to its memory. Both stacks are stored
stacked (``enc_layers``, ``dec_layers``) and run as Python loops over
their layers, each recomputed on backward when ``cfg.remat`` is set.
The decode cache is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, ops
from repro_torch.models.lm import _layer, _run
from repro_torch.models.param import ParamSpec


def src_len(cfg: ArchConfig, seq_len: int) -> int:
    """Frame count from the (stubbed) frontend: 1 frame per 4 tokens."""
    return max(16, seq_len // 4)


def param_specs(cfg: ArchConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    enc = {
        "attn_norm": ParamSpec((Le, d), ("layers", "embed"), init="ones"),
        "attn": blocks.attention_specs(cfg, Le),
        "ffn_norm": ParamSpec((Le, d), ("layers", "embed"), init="ones"),
        "ffn": blocks.ffn_specs(cfg, Le),
    }
    dec = {
        "self_norm": ParamSpec((Ld, d), ("layers", "embed"), init="ones"),
        "self_attn": blocks.attention_specs(cfg, Ld),
        "cross_norm": ParamSpec((Ld, d), ("layers", "embed"), init="ones"),
        "cross_attn": blocks.attention_specs(cfg, Ld),
        "ffn_norm": ParamSpec((Ld, d), ("layers", "embed"), init="ones"),
        "ffn": blocks.ffn_specs(cfg, Ld),
    }
    return {
        "embed": ParamSpec((V, d), ("vocab", "embed"), init="embed", scale=0.02),
        "enc_final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, V), ("embed", "vocab")),
        "enc_layers": enc,
        "dec_layers": dec,
    }


def enc_block(lp, h, cfg: ArchConfig, positions):
    x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + blocks.attention_apply(lp["attn"], x, cfg,
                                   positions=positions, causal=False)
    x = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + blocks.ffn_apply(lp["ffn"], x)


def encode(params, src_embeds, cfg: ArchConfig):
    """src_embeds: (B, S_src, d) -> encoder memory (B, S_src, d)."""
    h = src_embeds.to(cfg.cdtype())
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(cfg.n_encoder_layers):
        h = _run(enc_block, cfg, _layer(params["enc_layers"], i), h, cfg,
                 positions)
    return ops.rms_norm(h, params["enc_final_norm"], cfg.norm_eps)


def _cross_kv(lp_cross, memory, cfg: ArchConfig):
    """K/V of the encoder memory for one decoder layer (no rotation, no
    bias, as in the reference)."""
    B, S, _ = memory.shape
    KV, hd = cfg.n_kv_heads, cfg.hd()
    k = torch.matmul(memory, lp_cross["wk"].to(memory.dtype))
    v = torch.matmul(memory, lp_cross["wv"].to(memory.dtype))
    return k.reshape(B, S, KV, hd), v.reshape(B, S, KV, hd)


def dec_block(lp, h, memory, cfg: ArchConfig, positions):
    x = ops.rms_norm(h, lp["self_norm"], cfg.norm_eps)
    h = h + blocks.attention_apply(lp["self_attn"], x, cfg,
                                   positions=positions, causal=True)
    x = ops.rms_norm(h, lp["cross_norm"], cfg.norm_eps)
    kv = _cross_kv(lp["cross_attn"], memory, cfg)
    h = h + blocks.attention_apply(lp["cross_attn"], x, cfg,
                                   positions=positions, kv=kv)
    x = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + blocks.ffn_apply(lp["ffn"], x)


def decode_stack(params, h, memory, cfg: ArchConfig):
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(cfg.n_layers):
        h = _run(dec_block, cfg, _layer(params["dec_layers"], i), h, memory,
                 cfg, positions)
    return ops.rms_norm(h, params["final_norm"], cfg.norm_eps)


def loss_fn(params, batch, cfg: ArchConfig):
    memory = encode(params, batch["src_embeds"], cfg)
    h = params["embed"].to(cfg.cdtype())[batch["tokens"].long()]
    h = h * ops.sqrt_scale(cfg.d_model, cfg.cdtype())
    h = decode_stack(params, h, memory, cfg)
    tot, cnt = ops.chunked_softmax_xent(
        h, params["lm_head"], batch["targets"], chunk=cfg.loss_chunk,
        mask=batch.get("loss_mask"), remat=cfg.remat)
    xent = tot / torch.clamp(cnt, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return xent, {"xent": xent, "aux": aux, "tokens": cnt}
