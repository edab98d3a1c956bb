"""Shared numeric building blocks: norms, RoPE, attention (prefill and
single-token decode against a KV cache), the cache write, chunked xent.

Plain torch ops that mirror ``repro.models.ops`` op for op. Softmax
statistics are kept in f32 regardless of the compute dtype, and every
product the reference asks for with ``preferred_element_type=f32``
multiplies f32 up-casts of its (bf16) inputs: the products of two bf16
values are exact in f32 and the sum accumulates in f32, which is what
the reference computes — a bf16 product cast up afterwards is not.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def rms_norm(x, gamma, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)                       # (hd/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs          # (...,S,hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v, *, causal=True, window=0):
    """Causal GQA attention with an f32 masked softmax.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H % KV == 0. The
    reference's online softmax over one score tile (its tiles are 512 x
    1024, so every sequence up to 512 is one tile) in plain ops: scores
    in f32, masked to NEG_INF, un-normalized probabilities cast to v's
    dtype for the value product, normalized by their f32 sum last.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = (q * as_dtype(1.0 / D ** 0.5, q.dtype)).reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bckd->bqkgc", qr.float(), k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window and window > 0:
        ok &= kpos > qpos - window
    s = torch.where(ok[None, :, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bqkgc,bckd->bqkgd", p.to(v.dtype).float(), v.float())
    out = (acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype)
    return out.reshape(B, Sq, H, D)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    """Single-token attention against a KV cache.

    q: (B, H, D); k_cache/v_cache: (B, S, KV, D); pos: the index of the
    current token (an int or a 0-d tensor; entries > pos are invalid),
    and with ``window`` > 0 only entries > pos - window are valid.
    Scores in f32 (f32 products of the inputs), an f32 softmax, and the
    probabilities cast to v's dtype for the value product, as the
    reference's two ``preferred_element_type=f32`` einsums.
    """
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qr = (q * as_dtype(1.0 / D ** 0.5, q.dtype)).reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float())
    idx = torch.arange(S, device=q.device)
    ok = idx <= pos
    if window > 0:
        ok &= idx > pos - window
    s = torch.where(ok[None, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def cache_update(cache, new, pos):
    """Write ``new`` (B, KV, D) at sequence slot ``pos`` of ``cache``
    (B, S, KV, D), in place; returns ``cache``. The same bytes as the
    reference's masked write ``where(iota == pos, new, cache)``, without
    a second copy of the cache. ``pos`` may be a 0-d device tensor: no
    host sync."""
    slot = torch.as_tensor(pos, device=cache.device).reshape(1).long()
    return cache.index_copy_(1, slot, new[:, None].to(cache.dtype))


def swiglu(x, wg, wu, wd):
    g = torch.matmul(x, wg.to(x.dtype))
    u = torch.matmul(x, wu.to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, wd.to(x.dtype))


def _xent_chunk(hb, tb, mb, w_lm):
    # (B,chunk,D) @ (D,V) with f32 products and accumulation
    logits = torch.matmul(hb.float(), w_lm.to(hb.dtype).float())
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tb[..., None].long())[..., 0]
    loss = (lse - tgt) * mb
    return loss.sum(), mb.sum()


def chunked_softmax_xent(h, w_lm, targets, *, chunk=512, mask=None,
                         remat=True):
    """Cross-entropy without materializing (B, S, V) logits.

    h: (B, S, D) final hidden; w_lm: (D, V); targets: (B, S) int32.
    Returns (sum_loss, n_tokens). Chunks are recomputed on backward.
    """
    B, S, D = h.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    mr = (mask if mask is not None
          else torch.ones(targets.shape, dtype=torch.float32,
                          device=h.device))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        args = (h[:, i:i + chunk], targets[:, i:i + chunk],
                mr[:, i:i + chunk], w_lm)
        if remat and torch.is_grad_enabled():
            l, c = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            l, c = _xent_chunk(*args)
        tot = tot + l
        cnt = cnt + c
    return tot, cnt


def as_dtype(v: float, dtype) -> float:
    """A python scalar rounded to ``dtype`` first, as JAX rounds a weakly
    typed scalar to the array's dtype before ``x * v`` or ``x / v``
    (torch would apply it in f32 to a bf16 tensor)."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def sqrt_scale(d_model: int, dtype) -> float:
    """``jnp.asarray(np.sqrt(d), dtype)`` as a python float: the scale
    rounded to the compute dtype first, as the reference rounds it."""
    return as_dtype(math.sqrt(d_model), dtype)
