"""Decoder-only language model assembly (dense / moe / vlm / hybrid /
ssm), the port of ``repro.models.lm``: train/prefill and cached decode.

Parameters are the reference's stacked tree — every per-layer leaf has
a leading ``(L, …)`` dim under ``params["layers"]`` (xLSTM: ``L/2``
(mLSTM, sLSTM) pairs) — so frame leaf names and block layouts match.
The reference's ``lax.scan`` over layers is a Python loop over that
dim, and its per-layer ``jax.checkpoint`` is ``torch.utils.checkpoint``
(``cfg.remat``). Hybrid (Hymba) layers take their attention window from
``layer_windows``. Decode runs the same loop over per-layer slices of
the stacked caches (``DecodeCache``), which it updates in place.

Batch dicts:
  train/prefill: {"tokens": (B,S) int32, "targets": (B,S) int32,
                  ["patch_embeds": (B,P,Fd), "loss_mask": (B,S) f32]}
  decode:        {"tokens": (B,1) int32, "pos": () int32}
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch import tree_leaves
from repro_torch.models import blocks, linear_attn as la, moe as moe_lib
from repro_torch.models import ops, xlstm
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


def logits_fn(params, batch, cfg: ArchConfig):
    """Prefill: final-position logits (B, V) in f32 (f32 products of the
    compute-dtype inputs) — the serving entry point."""
    h, _ = forward(params, batch, cfg)
    w = lm_head_weight(params, cfg)
    return torch.matmul(h[:, -1].float(), w.to(h.dtype).float())


# --------------------------------------------------------------------------
# Decode (single token, cached)
# --------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Stacked per-layer caches. Unused fields are () placeholders."""
    k: Any = ()
    v: Any = ()
    mamba: Any = ()
    mlstm: Any = ()
    slstm: Any = ()


def cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """Ring-buffer length: full-attn archs bound long contexts by window."""
    if cfg.sliding_window:
        need = cfg.sliding_window
        if cfg.global_attn_layers:
            return seq_len            # hybrid keeps global layers full
        return min(seq_len, need)
    if seq_len > 65536 and cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        return 8192                    # sub-quadratic long-context variant
    return seq_len


def la_state(mk, s_shape, n_shape, m_shape) -> la.LinState:
    return la.LinState(mk(s_shape, torch.float32), mk(n_shape, torch.float32),
                       mk(m_shape, torch.float32))


def init_cache(cfg: ArchConfig, B: int, seq_len: int, device=None):
    """Zero caches for ``B`` requests of up to ``seq_len`` tokens, the
    reference's tree: k/v (L, B, Lc, KV, hd) in the compute dtype, the
    recurrent states in f32."""
    Lc = cache_len(cfg, seq_len)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd()

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.arch_type == "ssm":
        d, di, H, hp = xlstm._dims(cfg)
        n_pairs = cfg.n_layers // 2
        mc = xlstm.MLSTMCache(
            la_state(mk, (n_pairs, B, H, hp, hp), (n_pairs, B, H, hp),
                     (n_pairs, B, H)),
            mk((n_pairs, B, cfg.ssm.conv_width - 1, di), torch.float32))
        sc = xlstm.SLSTMState(*[mk((n_pairs, B, d), torch.float32)
                                for _ in range(4)])
        return DecodeCache(mlstm=mc, slstm=sc)

    k = mk((L, B, Lc, KV, hd), cfg.cdtype())
    v = mk((L, B, Lc, KV, hd), cfg.cdtype())
    if cfg.arch_type == "hybrid":
        di, N, Hm, hp = blocks._mamba_dims(cfg)
        mam = blocks.MambaCache(
            la_state(mk, (L, B, Hm, N, hp), (L, B, Hm, N), (L, B, Hm)),
            mk((L, B, cfg.ssm.conv_width - 1, di), torch.float32))
        return DecodeCache(k=k, v=v, mamba=mam)
    return DecodeCache(k=k, v=v)


def cache_slice(stacked, i: int):
    """Layer ``i`` of a stacked cache NamedTuple (views)."""
    return type(stacked)(*(cache_slice(f, i) if isinstance(f, tuple)
                           else f[i] for f in stacked))


def cache_store(stacked, i: int, new) -> None:
    """Write one layer's new cache into slice ``i`` of the stacked one."""
    for dst, src in zip(tree_leaves(stacked), tree_leaves(new)):
        dst[i].copy_(src)


def decode_block(lp, h, cfg: ArchConfig, ck, cv, pos, *, window: int = 0,
                 ring: bool = False, mam=None):
    """Single-layer decode. Returns (h, k', v', mamba_cache')."""
    x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    # hybrid: windowed layers keep a full-length cache and the mask
    # applies the window; the ring is only for long-context dense
    a_out, ck2, cv2 = blocks.attention_decode(
        lp["attn"], x, cfg, ck, cv, pos, window=window, ring=ring)
    if cfg.arch_type == "hybrid":
        m_out, mam = blocks.mamba_decode(lp["mamba"], x, cfg, mam)
        a_out = 0.5 * (a_out + m_out)
    h = h + a_out
    x = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    if cfg.arch_type == "moe":
        f_out, _ = moe_lib.moe_apply(lp["moe"], x, cfg)
    else:
        f_out = blocks.ffn_apply(lp["ffn"], x)
    return h + f_out, ck2, cv2, mam


def ssm_decode_block(lp, h, cfg: ArchConfig, mc, sc):
    h, mc2 = xlstm.mlstm_decode(lp["mlstm"], h, cfg, mc)
    h, sc2 = xlstm.slstm_decode(lp["slstm"], h, cfg, sc)
    return h, mc2, sc2


def embed_decode(params, batch, cfg: ArchConfig):
    """The token's embedding (B, 1, d) in the compute dtype, scaled; the
    rows are gathered before the cast (the same bits as casting the
    table first)."""
    h = params["embed"][batch["tokens"].long()].to(cfg.cdtype())
    return h * ops.sqrt_scale(cfg.d_model, cfg.cdtype())


def decode_step(params, cache: DecodeCache, batch, cfg: ArchConfig,
                seq_len: int):
    """One-token decode. batch: {"tokens": (B,1), "pos": ()} ->
    (logits (B, V) f32, cache). The cache's tensors are updated in place
    and returned in a new ``DecodeCache``."""
    h = embed_decode(params, batch, cfg)
    pos = torch.as_tensor(batch["pos"], device=h.device)
    Lc = cache_len(cfg, seq_len)
    ring = Lc < seq_len
    layers = params["layers"]

    if cfg.arch_type == "ssm":
        for i in range(cfg.n_layers // 2):
            h, mc, sc = ssm_decode_block(
                _layer(layers, i), h, cfg, cache_slice(cache.mlstm, i),
                cache_slice(cache.slstm, i))
            cache_store(cache.mlstm, i, mc)
            cache_store(cache.slstm, i, sc)
        new_cache = DecodeCache(mlstm=cache.mlstm, slstm=cache.slstm)
    else:
        hybrid = cfg.arch_type == "hybrid"
        windows = layer_windows(cfg).tolist()
        for i in range(cfg.n_layers):
            mam = cache_slice(cache.mamba, i) if hybrid else None
            h, _, _, mam = decode_block(_layer(layers, i), h, cfg,
                                        cache.k[i], cache.v[i], pos,
                                        window=int(windows[i]), ring=ring,
                                        mam=mam)
            if hybrid:
                cache_store(cache.mamba, i, mam)
        new_cache = DecodeCache(k=cache.k, v=cache.v,
                                mamba=cache.mamba if hybrid else ())

    h = ops.rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = lm_head_weight(params, cfg)
    logits = torch.matmul(h[:, 0].float(), w.to(h.dtype).float())
    return logits, new_cache
