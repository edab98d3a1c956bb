"""xLSTM blocks (mLSTM + sLSTM) [arXiv:2405.04517] (port of
``repro.models.xlstm``, train path).

mLSTM: matrix-memory LSTM — exponential input gate, sigmoid forget gate,
running-max stabilizer and normalizer state. Computed with the shared
chunkwise linear-attention engine (``stabilize=True, normalize=True``).

sLSTM: scalar-memory recurrent cell with block-diagonal (per-head)
recurrent weights — inherently sequential: the reference's ``lax.scan``
over time is a Python loop over the sequence here.

Blocks alternate mLSTM/sLSTM (``cfg.slstm_every == 2``): the layer stack
is stored and run as *pairs*. Decode carries the mLSTM's (S, n, m) state
and conv inputs (``MLSTMCache``) and the sLSTM's (h, c, n, m).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import linear_attn as la
from repro_torch.models import ops
from repro_torch.models.blocks import _causal_conv
from repro_torch.models.param import ParamSpec


def _dims(cfg: ArchConfig):
    d = cfg.d_model
    di = cfg.ssm.expand * d        # mLSTM inner dim
    H = cfg.n_heads
    hp = di // H                   # mLSTM per-head value dim
    return d, di, H, hp


# --------------------------- mLSTM ----------------------------------------

def mlstm_specs(cfg: ArchConfig, layers: int) -> dict:
    d, di, H, hp = _dims(cfg)
    L = (layers,)
    return {
        "norm": ParamSpec(L + (d,), ("layers", "embed"), init="ones"),
        "w_up": ParamSpec(L + (d, 2 * di), ("layers", "fsdp", "mlp")),
        "conv": ParamSpec(L + (cfg.ssm.conv_width, di),
                          ("layers", "conv", "mlp"), init="normal", scale=0.5),
        "wq": ParamSpec(L + (di, di), ("layers", "mlp", "heads")),
        "wk": ParamSpec(L + (di, di), ("layers", "mlp", "heads")),
        "wv": ParamSpec(L + (di, di), ("layers", "mlp", "heads")),
        "w_if": ParamSpec(L + (di, 2 * H), ("layers", "mlp", "heads"),
                          init="zeros"),
        "b_if": ParamSpec(L + (2 * H,), ("layers", "heads"), init="zeros"),
        "gnorm": ParamSpec(L + (di,), ("layers", "mlp"), init="ones"),
        "w_down": ParamSpec(L + (di, d), ("layers", "mlp", "fsdp")),
    }


def _mlstm_inner(p, xm, cfg: ArchConfig):
    """xm: (B,S,di) post-conv. Returns q,k,v,(ld,li) for the engine."""
    B, S, di = xm.shape
    d, _, H, hp = _dims(cfg)
    q = torch.matmul(xm, p["wq"].to(xm.dtype)).reshape(B, S, H, hp)
    k = torch.matmul(xm, p["wk"].to(xm.dtype)).reshape(B, S, H, hp)
    k = k / ops.as_dtype(hp ** 0.5, k.dtype)
    v = torch.matmul(xm, p["wv"].to(xm.dtype)).reshape(B, S, H, hp)
    gates = (torch.matmul(xm, p["w_if"].to(xm.dtype)).float()
             + p["b_if"].float())
    li, f_raw = gates[..., :H], gates[..., H:]
    ld = F.logsigmoid(f_raw)
    return q, k, v, ld, li


def mlstm_apply(p, h, cfg: ArchConfig):
    B, S, d = h.shape
    _, di, H, hp = _dims(cfg)
    x = ops.rms_norm(h, p["norm"], cfg.norm_eps)
    up = torch.matmul(x, p["w_up"].to(x.dtype))
    xm, z = up[..., :di], up[..., di:]
    xm = F.silu(_causal_conv(xm, p["conv"]).float()).to(x.dtype)
    q, k, v, ld, li = _mlstm_inner(p, xm, cfg)
    y = la.chunked(q, k, v, ld, li, chunk=cfg.ssm.chunk,
                   normalize=True, stabilize=True)
    y = y.reshape(B, S, di)
    y = ops.rms_norm(y, p["gnorm"], cfg.norm_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    return h + torch.matmul(y, p["w_down"].to(x.dtype))


class MLSTMCache(NamedTuple):
    state: la.LinState
    conv: torch.Tensor      # (B, W-1, di) trailing inputs, f32


def mlstm_cache(cfg: ArchConfig, B, device=None) -> MLSTMCache:
    d, di, H, hp = _dims(cfg)
    return MLSTMCache(la.init_state(B, H, hp, hp, device=device),
                      torch.zeros((B, cfg.ssm.conv_width - 1, di),
                                  dtype=torch.float32, device=device))


def mlstm_decode(p, h, cfg: ArchConfig, cache: MLSTMCache):
    """h: (B,1,d) -> (h', new cache): one step of the conv and of the
    stabilized, normalized recurrence."""
    B = h.shape[0]
    _, di, H, hp = _dims(cfg)
    x = ops.rms_norm(h, p["norm"], cfg.norm_eps)
    up = torch.matmul(x, p["w_up"].to(x.dtype))
    xm, z = up[..., :di], up[..., di:]
    hist = torch.cat([cache.conv, xm.float()], dim=1)
    xm1 = F.silu((hist * p["conv"].float()).sum(dim=1))
    xm1 = xm1.to(x.dtype)[:, None]                        # (B,1,di)
    q, k, v, ld, li = _mlstm_inner(p, xm1, cfg)
    st, y = la.decode_step(cache.state, q[:, 0], k[:, 0], v[:, 0],
                           ld[:, 0], li[:, 0], normalize=True,
                           stabilize=True)
    y = y.reshape(B, 1, di).to(x.dtype)
    y = ops.rms_norm(y, p["gnorm"], cfg.norm_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    out = h + torch.matmul(y, p["w_down"].to(x.dtype))
    return out, MLSTMCache(st, hist[:, 1:])


# --------------------------- sLSTM ----------------------------------------

def slstm_specs(cfg: ArchConfig, layers: int) -> dict:
    d, _, H, _ = _dims(cfg)
    hs = d // H                     # per-head scalar-memory width
    fup = (8 * d) // 6              # post-block gated FFN (factor 4/3)
    L = (layers,)
    return {
        "norm": ParamSpec(L + (d,), ("layers", "embed"), init="ones"),
        "w_gates": ParamSpec(L + (d, 4 * d), ("layers", "fsdp", "mlp")),
        "r_gates": ParamSpec(L + (H, hs, 4 * hs), ("layers", "heads", None, None),
                             init="normal", scale=0.5),
        "b_gates": ParamSpec(L + (4 * d,), ("layers", "mlp"), init="zeros"),
        "gnorm": ParamSpec(L + (d,), ("layers", "embed"), init="ones"),
        "up_norm": ParamSpec(L + (d,), ("layers", "embed"), init="ones"),
        "w_up": ParamSpec(L + (d, 2 * fup), ("layers", "fsdp", "mlp")),
        "w_down": ParamSpec(L + (fup, d), ("layers", "mlp", "fsdp")),
    }


class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, d)
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def slstm_state(cfg: ArchConfig, B, device=None):
    z = torch.zeros((B, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, z)


def _slstm_step(p, st: SLSTMState, wx_t, cfg: ArchConfig):
    """wx_t: (B, 4d) precomputed input part. Returns (new state, h_out)."""
    d, _, H, _ = _dims(cfg)
    hs = d // H
    B = wx_t.shape[0]
    hprev = st.h.reshape(B, H, hs)
    rec = torch.einsum("bhs,hsg->bhg", hprev,
                       p["r_gates"].float()).reshape(B, 4 * d)
    g = (wx_t + rec).reshape(B, 4, d)
    li, lf_raw, z_raw, o_raw = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    lf = F.logsigmoid(lf_raw)
    m_new = torch.maximum(lf + st.m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + st.m - m_new)
    c = f_p * st.c + i_p * torch.tanh(z_raw)
    n = f_p * st.n + i_p
    # max(n, 1) splits a tie's gradient as JAX's max does: at t = 0,
    # n is exactly 1 whenever the input gate sets the stabilizer
    h = torch.sigmoid(o_raw) * c / torch.maximum(n, n.new_ones(()))
    return SLSTMState(h, c, n, m_new), h


def slstm_apply(p, hres, cfg: ArchConfig, state: SLSTMState = None):
    """With ``state`` returns (out, final state), else out."""
    B, S, d = hres.shape
    x = ops.rms_norm(hres, p["norm"], cfg.norm_eps)
    wx = (torch.matmul(x, p["w_gates"].to(x.dtype)).float()
          + p["b_gates"].float())
    st = state if state is not None else slstm_state(cfg, B, hres.device)
    ys = []
    for t in range(S):
        st, h = _slstm_step(p, st, wx[:, t], cfg)
        ys.append(h)
    y = torch.stack(ys, dim=1).to(x.dtype)                # (B,S,d)
    y = ops.rms_norm(y, p["gnorm"], cfg.norm_eps)
    h1 = hres + y
    # gated up/down projection (xLSTM post-sLSTM FFN, factor 4/3);
    # jax.nn.gelu is the tanh approximation by default
    x2 = ops.rms_norm(h1, p["up_norm"], cfg.norm_eps)
    up = torch.matmul(x2, p["w_up"].to(x2.dtype))
    a, b = torch.chunk(up, 2, dim=-1)
    hmid = F.gelu(a.float(), approximate="tanh").to(x2.dtype) * b
    out = h1 + torch.matmul(hmid, p["w_down"].to(x2.dtype))
    return (out, st) if state is not None else out


def slstm_decode(p, hres, cfg: ArchConfig, state: SLSTMState):
    """One step of ``slstm_apply`` from ``state``: (out, state')."""
    return slstm_apply(p, hres, cfg, state=state)
