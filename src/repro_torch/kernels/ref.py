"""Plain-torch versions of the port's kernels.

Each repeats its kernel's arithmetic op for op, on (nb, block) tiles:
the CPU path runs them, the tests hold them against the reference's
Pallas kernels, and ``chip_smoke.py`` holds the CUDA kernels against them
on the card. They are not yardsticks of speed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def to_blocks(x: torch.Tensor, block: int):
    """Flatten and zero-pad to whole blocks: (nb, block) and the
    unpadded block count nb. (The reference also pads nb to its 8-row
    Pallas tile; the rows it adds are sliced off again, so nb and the
    zero tail are all that reach the results.)"""
    flat = x.reshape(-1)
    pad = (block - flat.numel() % block) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    xb = flat.reshape(-1, block)
    return xb, xb.shape[0]


def unblock(xb: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= int(d)
    out = xb.reshape(-1)[:n].reshape(shape)
    return out if dtype is None else out.to(dtype)


def topk_select_ref(xb: torch.Tensor, k: int):
    """xb: (nb, block) -> (values (nb,k) in xb.dtype, int32 indices):
    k rounds of argmax (first maximum) on the f32 magnitude, the pick
    marked -1 so zero magnitudes are still taken in index order."""
    mag = torch.abs(xb.float())
    idxs = []
    for _ in range(k):
        i = torch.argmax(mag, dim=1, keepdim=True)      # (nb, 1)
        idxs.append(i)
        mag.scatter_(1, i, -1.0)
    idx = (torch.cat(idxs, dim=1) if idxs else
           torch.zeros((xb.shape[0], 0), dtype=torch.long, device=xb.device))
    return torch.gather(xb, 1, idx), idx.to(torch.int32)


def absmax_quantize(x: torch.Tensor, amax: torch.Tensor, qmax: float):
    """The absmax codec shared by K5, K8 and K11: scale = max(amax *
    f32(1/qmax), 1e-12) — a reciprocal multiply, what the reference
    computes under ``jax.jit`` — and q = clip(round-half-even(x / scale),
    +-qmax) with a true division. Returns (q int32, scale f32)."""
    recip = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    floor = torch.tensor(1e-12, dtype=torch.float32, device=x.device)
    scale = torch.maximum(amax * recip, floor)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    return q, scale


def topk_scatter_ref(vals: torch.Tensor, idxs: torch.Tensor, block: int):
    """(nb, k) values + block-local indices -> dense (nb, block): added
    in f32 into zeros, cast to the values' dtype."""
    out = torch.zeros((vals.shape[0], block), dtype=torch.float32,
                      device=vals.device)
    out.scatter_add_(1, idxs.long(), vals.float())
    return out.to(vals.dtype)


# -------------------- packed and quant8 compressors (K8, K9, K11, K12) --

def pack_select_ref(xb: torch.Tensor, k: int):
    """K8: the top-k of :func:`topk_select_ref`, the f32 picks quantized
    to int8 against the block's absmax (the first pick). xb: (nb, block)
    -> (q int8 (nb, k), int32 indices (nb, k), scale f32 (nb, 1))."""
    vals, idx = topk_select_ref(xb, k)
    vals = vals.float()
    q, scale = absmax_quantize(vals, vals[:, :1].abs(), 127.0)
    return q.to(torch.int8), idx, scale


def pack_scatter_ref(q, idxs, scale, block: int) -> torch.Tensor:
    """K9: f32(q) * scale added into zeros at the block-local indices ->
    dense f32 (nb, block)."""
    out = torch.zeros((q.shape[0], block), dtype=torch.float32,
                      device=q.device)
    out.scatter_add_(1, idxs.long(), q.float() * scale.reshape(-1, 1))
    return out


def quantize_ref(xb: torch.Tensor):
    """K11: per-block absmax int8. xb: (nb, block) -> (q int8 (nb,
    block), scale f32 (nb, 1))."""
    x = xb.float()
    q, scale = absmax_quantize(x, x.abs().amax(dim=1, keepdim=True), 127.0)
    return q.to(torch.int8), scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K12: f32(q) * scale per block -> (nb, block) f32."""
    return q.float() * scale.reshape(-1, 1)


def adam_tile_update_ref(p, g, mu, nu, hyper):
    """K3: hyper (1, 8) f32 = [lr, b1, b2, eps, c1, c2, -, -]; the moment
    complements 1-b1 / 1-b2 are computed in f32."""
    lr, b1, b2, eps, c1, c2 = (hyper[0, i] for i in range(6))
    pf, gf = p.float(), g.float()
    mu2 = b1 * mu + (1.0 - b1) * gf
    nu2 = b2 * nu + (1.0 - b2) * gf * gf
    step = lr * (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
    return (pf - step).to(p.dtype), mu2, nu2


def adam_replay_update_ref(p, g, mu, nu, hyper):
    """K4's Adam tail: as :func:`adam_tile_update_ref` but the moment
    complements come pre-rounded from hyper slots 6/7, which matches
    ``optim.adam.adam_update``."""
    lr, b1, b2, eps, c1, c2, om1, om2 = (hyper[0, i] for i in range(8))
    pf, gf = p.float(), g.float()
    mu2 = b1 * mu + om1 * gf
    nu2 = b2 * nu + om2 * gf * gf
    step = lr * (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
    return (pf - step).to(p.dtype), mu2, nu2


def topk_apply_ref(vals, idxs, p, mu, nu, hyper, *, block: int):
    """K4: scatter-decode a top-k wire payload (added in f32 into zeros)
    and apply one Adam step. p/mu/nu: (nb, block)."""
    g = torch.zeros((vals.shape[0], block), dtype=torch.float32,
                    device=vals.device)
    g.scatter_add_(1, idxs.long(), vals.float())
    return adam_replay_update_ref(p, g, mu, nu, hyper)


def packed_apply_ref(q, idxs, scale, p, mu, nu, hyper, *, block: int):
    """K10: dequantize a packed payload (f32(q) * scale), then K4."""
    return topk_apply_ref(q.float() * scale.reshape(-1, 1), idxs, p, mu, nu,
                          hyper, block=block)


def quant_apply_ref(q, scale, p, mu, nu, hyper):
    """K13: g = f32(q) * scale, dense, then K4's Adam tail. q: (nb,
    block) int8; scale: nb f32 (any shape)."""
    return adam_replay_update_ref(p, dequantize_ref(q, scale), mu, nu, hyper)


# -------------------- quantized row-span codec (K5-K7) ---------------

def span_pack_ref(x2d: torch.Tensor, bits: int):
    """K5: per-row absmax quantize an (n, cols) row block -> (q (n,
    wire_cols) int8 | nibble-packed uint8, scale (n, 1) f32). scale =
    max(absmax * f32(1/qmax), 1e-12), q = clip(round-half-even(x /
    scale), +-qmax); an odd int4 row gets a zero pad column."""
    x = x2d.float()
    n, cols = x.shape
    qmax = 127.0 if bits == 8 else 7.0
    if cols == 0:
        return (torch.zeros((n, 0), dtype=torch.int8 if bits == 8
                            else torch.uint8, device=x.device),
                torch.full((n, 1), 1e-12, dtype=torch.float32,
                           device=x.device))
    if bits == 4 and cols % 2:
        x = F.pad(x, (0, 1))
    qi, scale = absmax_quantize(x, x.abs().amax(dim=1, keepdim=True), qmax)
    if bits == 8:
        return qi.to(torch.int8), scale
    lo = qi[:, 0::2] & 0xF
    hi = qi[:, 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8), scale


def span_decode_ref(q: torch.Tensor, scale: torch.Tensor, cols: int,
                    bits: int) -> torch.Tensor:
    """K6: wire bytes -> dense f32 (n, cols) = f32(q) * scale, the int4
    nibbles (low = even column) sign-extended."""
    if bits == 8:
        g = q.float()
    else:
        u = q.to(torch.int32)
        lo = u & 0xF
        hi = (u >> 4) & 0xF
        lo = torch.where(lo > 7, lo - 16, lo)
        hi = torch.where(hi > 7, hi - 16, hi)
        g = torch.stack([lo, hi], dim=2).reshape(q.shape[0], -1).float()
    return g[:, :cols] * scale.reshape(-1, 1)


def quant_span_apply_ref(q, scale, dst: torch.Tensor, start: int, *,
                         bits: int) -> torch.Tensor:
    """K7: decode one row-span payload into rows [start, start + n) of
    ``dst``, cast to its dtype, in place; returns ``dst``."""
    n = q.shape[0]
    cols = 1
    for d in dst.shape[1:]:
        cols *= int(d)
    rows = span_decode_ref(q, scale, cols, bits)
    dst[start:start + n] = rows.reshape((n,) + tuple(dst.shape[1:])).to(
        dst.dtype)
    return dst
