"""Encoder-decoder backbone (SeamlessM4T-medium assignment), the port of
``repro.models.encdec``: train/prefill and cached decode.

The audio frontend (mel-spectrogram + conformer feature extractor) is a
stub, as in the reference: the batch carries precomputed frame
embeddings ``src_embeds`` (B, S_src, d_model). The transformer encoder
(non-causal, rotating its own positions) runs over those frames and the
causal decoder cross-attends to its memory. Both stacks are stored
stacked (``enc_layers``, ``dec_layers``) and run as Python loops over
their layers, each recomputed on backward when ``cfg.remat`` is set.
Decode keeps the decoder's self-attention K/V and the encoder memory's
cross K/V per layer (``EncDecCache``); ``prefill_cache`` fills the
latter.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, ops
from repro_torch.models.lm import _layer, _run, cache_len, embed_decode
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


def logits_fn(params, batch, cfg: ArchConfig):
    """Prefill: final-position logits (B, V) in f32."""
    memory = encode(params, batch["src_embeds"], cfg)
    h = params["embed"].to(cfg.cdtype())[batch["tokens"].long()]
    h = h * ops.sqrt_scale(cfg.d_model, cfg.cdtype())
    h = decode_stack(params, h, memory, cfg)
    return torch.matmul(h[:, -1].float(),
                        params["lm_head"].to(h.dtype).float())


class EncDecCache(NamedTuple):
    k: Any           # (L, B, Sc, KV, hd) decoder self-attention
    v: Any
    cross_k: Any     # (L, B, S_src, KV, hd) precomputed encoder K/V
    cross_v: Any


def init_cache(cfg: ArchConfig, B: int, seq_len: int, device=None):
    """Zero caches; the cross K/V hold ``src_len`` frames of a context
    of ``seq_len`` (at most 32,768) tokens."""
    Lc = cache_len(cfg, seq_len)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd()
    Ss = src_len(cfg, min(seq_len, 32768))

    def mk(shape):
        return torch.zeros(shape, dtype=cfg.cdtype(), device=device)

    return EncDecCache(mk((L, B, Lc, KV, hd)), mk((L, B, Lc, KV, hd)),
                       mk((L, B, Ss, KV, hd)), mk((L, B, Ss, KV, hd)))


def cache_logical(cfg: ArchConfig):
    """Logical-axis tree matching ``init_cache`` output (for sharding)."""
    kv = ("layers", "batch", "kvseq", "kv_heads", None)
    xkv = ("layers", "batch", "frames", "kv_heads", None)
    return EncDecCache(kv, kv, xkv, xkv)


def prefill_cache(params, batch, cfg: ArchConfig, B, seq_len):
    """Build the decode cache: encode the source, precompute every
    decoder layer's cross K/V."""
    memory = encode(params, batch["src_embeds"], cfg)
    kv = [_cross_kv(_layer(params["dec_layers"], i)["cross_attn"], memory,
                    cfg) for i in range(cfg.n_layers)]
    base = init_cache(cfg, B, seq_len, device=memory.device)
    return base._replace(cross_k=torch.stack([k for k, _ in kv]),
                         cross_v=torch.stack([v for _, v in kv]))


def dec_decode_block(lp, h, cfg: ArchConfig, ck, cv, xk, xv, pos, ring):
    x = ops.rms_norm(h, lp["self_norm"], cfg.norm_eps)
    a, ck2, cv2 = blocks.attention_decode(lp["self_attn"], x, cfg,
                                          ck, cv, pos, ring=ring)
    h = h + a
    x = ops.rms_norm(h, lp["cross_norm"], cfg.norm_eps)
    a, _, _ = blocks.attention_decode(lp["cross_attn"], x, cfg,
                                      ck, cv, pos, cross_kv=(xk, xv))
    h = h + a
    x = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + blocks.ffn_apply(lp["ffn"], x), ck2, cv2


def decode_step(params, cache: EncDecCache, batch, cfg: ArchConfig,
                seq_len: int):
    """One-token decode -> (logits (B, V) f32, cache); the self K/V are
    written in place."""
    h = embed_decode(params, batch, cfg)
    pos = torch.as_tensor(batch["pos"], device=h.device)
    ring = cache_len(cfg, seq_len) < seq_len
    for i in range(cfg.n_layers):
        h, _, _ = dec_decode_block(_layer(params["dec_layers"], i), h, cfg,
                                   cache.k[i], cache.v[i], cache.cross_k[i],
                                   cache.cross_v[i], pos, ring)
    h = ops.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(h[:, 0].float(),
                          params["lm_head"].to(h.dtype).float())
    return logits, cache
