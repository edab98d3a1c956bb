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


def split3_bf16(g: torch.Tensor) -> torch.Tensor:
    """f32 ``g`` as its three-term bf16 split stacked on dim 0: hi =
    bf16(g), mid = bf16(g - hi), lo = bf16(g - hi - mid), each rounded
    to nearest even. Each subtraction is exact in f32, so hi + mid + lo
    == g bit for bit while lo stays a normal bf16."""
    hi = g.to(torch.bfloat16)
    r1 = g - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return torch.cat([hi, mid, lo], dim=0)


def xent_rows_ref(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, n_valid: int):
    """``xent_rows``: per row of f32 ``logits`` (R, ld) whose first
    ``n_valid`` columns are the vocabulary, (lse, tgt, (lse - tgt) *
    mask), each (R,) f32."""
    x = logits[:, :n_valid]
    lse = torch.logsumexp(x, dim=-1)
    tgt = torch.gather(x, -1, targets[:, None].long())[:, 0]
    return lse, tgt, (lse - tgt) * mask


def xent_grad_split_ref(logits: torch.Tensor, lse: torch.Tensor,
                        targets: torch.Tensor, mask: torch.Tensor,
                        dtot: torch.Tensor, n_valid: int) -> torch.Tensor:
    """``xent_grad_split``: the gradient of sum((lse - tgt) * mask) *
    dtot with respect to the logits, formed as autograd forms it (gm =
    dtot * mask; gm * exp(x - lse), and -gm added at the target), zero in
    the padding columns, as :func:`split3_bf16` planes: (3R, ld) bf16."""
    x = logits[:, :n_valid]
    gm = (dtot.reshape(()) * mask)[:, None]
    g = (gm * torch.exp(x - lse[:, None])).scatter_add(
        1, targets[:, None].long(), -gm)
    g = F.pad(g, (0, logits.shape[1] - n_valid))
    return split3_bf16(g)


def rounded_apart(got: torch.Tensor, want: torch.Tensor,
                  terms=None) -> tuple:
    """How far ``got`` lies from ``want`` where both round the same f32
    values, summed in other orders: (the largest |got - want| over its
    bound, the share of elements that differ). Within the bound, the
    ratio is at most 1.

    Without ``terms``, both are one rounding to bf16: an element may land
    on the neighbouring bf16 value, one spacing away, at most 2^-7 of
    it; a sum that cancels far below the tensor's scale is off by the
    f32 rounding of its larger parts, so the spacing at 2^-10 of the
    largest element is added. With ``terms`` (the reference's summands,
    each such a rounding, in the order ``want`` summed them in its own
    dtype), each term brings its own bound as above, and each partial
    sum, rounded to ``want``'s dtype, one spacing of itself."""
    a, b = got.float(), want.float()

    def one(x):
        x = x.float().abs()
        return 2.0 ** -7 * (x + 2.0 ** -10 * float(x.max()))
    if terms is None:
        bound = one(b)
    else:
        eps = torch.finfo(want.dtype).eps
        bound = one(terms[0])
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
            bound = bound + one(t) + eps * acc.float().abs()
    differ = a != b
    ratio = torch.where(differ, (a - b).abs() / bound, torch.zeros_like(a))
    return float(ratio.max()), float(differ.float().mean())


def moe_plan_ref(eid: torch.Tensor, first: int, n: int, C: int):
    """``moe_plan``: (dest, valid, src) of the assignments ``eid`` (T, K)
    to the ``n`` experts from ``first`` with ``C`` slots each, by a
    stable sort of the flat assignments by expert (those to experts not
    held last): an assignment's position among its expert's is its index
    in the sorted order less the index where that expert starts. No
    shape here depends on the data (the dry run's fake tensors)."""
    rel = eid.reshape(-1) - first
    TK = rel.numel()
    idx = torch.arange(TK, dtype=torch.int64, device=eid.device)
    mine = (rel >= 0) & (rel < n)
    key = torch.where(mine, rel, torch.full_like(rel, n))
    skey, order = torch.sort(key, stable=True)
    start = torch.searchsorted(skey, torch.arange(
        n + 1, dtype=skey.dtype, device=eid.device))
    pos = torch.empty_like(rel)
    pos[order] = idx - start[skey]
    valid = mine & (pos < C)
    dest = torch.where(valid, key * C + pos, torch.full_like(rel, n * C))
    src = torch.full((n * C + 1,), -1, dtype=torch.int64, device=eid.device)
    return dest, valid, src.scatter_(0, dest, idx)[:n * C]


def slot_gather_ref(x: torch.Tensor, src: torch.Tensor, K: int, w=None,
                    dot_rows=None):
    """``moe_slot_gather``: out[s] = x[src[s] // K] * w[src[s]] (without
    ``w`` the row), zeros where src[s] < 0; with ``dot_rows`` also dots
    (T·K,) f32: for the assignment a filling slot s, the f32 sum of the
    products x[t] * dot_rows[s] rounded to x's dtype, 0 elsewhere."""
    filled = src >= 0
    a = src.clamp(min=0)
    rows = x[a // K]
    out = rows if w is None else rows * w.reshape(-1)[a][:, None]
    out = torch.where(filled[:, None], out, torch.zeros((), dtype=x.dtype))
    if dot_rows is None:
        return out
    TK = x.shape[0] * K
    dot = (rows * dot_rows).float().sum(-1)
    dots = torch.zeros((TK + 1,), dtype=torch.float32, device=x.device)
    dots.scatter_(0, torch.where(filled, a, torch.full_like(a, TK)), dot)
    return out, dots[:TK]


def assign_gather_ref(rows: torch.Tensor, dest: torch.Tensor, K: int,
                      w=None) -> torch.Tensor:
    """``moe_assign_gather``: out[t] = the sum over k = 0..K-1 whose slot
    dest[t·K + k] lies in [0, R) of rows[slot] * w[t·K + k] (without
    ``w``, the row), from zero, in k order, every product and add
    rounded to rows' dtype."""
    R, d = rows.shape
    dk = dest.reshape(-1, K)
    kept = (dk >= 0) & (dk < R)
    idx = dk.clamp(0, R - 1)
    wk = None if w is None else w.reshape(-1, K)
    out = torch.zeros((dk.shape[0], d), dtype=rows.dtype, device=rows.device)
    for k in range(K):
        term = rows[idx[:, k]]
        if wk is not None:
            term = term * wk[:, k, None]
        out = torch.where(kept[:, k, None], out + term, out)
    return out


def moe_cumsum_plan_ref(eid: torch.Tensor, first: int, n: int, C: int):
    """The MoE layer's plan before the slot map, (dest, valid) as
    ``moe_plan`` gives them: an assignment's position among those to its
    expert is the exclusive cumsum of the (T·K, n) f32 one-hot of the
    assignments to the experts ``[first, first + n)`` (others masked
    out)."""
    T, K = eid.shape
    rel = eid - first
    mine = (rel >= 0) & (rel < n)
    oh = torch.where(mine[..., None],
                     torch.nn.functional.one_hot(rel.clamp(0, n - 1),
                                                 n).float(),
                     0.0).reshape(T * K, n)
    pos = ((torch.cumsum(oh, dim=0) - oh) * oh).sum(-1).to(torch.int64)
    valid = mine.reshape(T * K) & (pos < C)
    dest = torch.where(valid, rel.reshape(T * K).clamp(0, n - 1) * C + pos,
                       torch.full_like(pos, n * C))
    return dest, valid


def moe_scatter_dispatch_ref(xf: torch.Tensor, dest: torch.Tensor, n: int,
                             C: int, K: int) -> torch.Tensor:
    """The MoE layer's dispatch before the slot map: K scatter-adds of
    the token rows ``xf`` (T, d) into (n·C + 1, d) buffers whose last
    row (the drop slot) is thrown away: (n, C, d)."""
    T, d = xf.shape
    dest_k = dest.reshape(T, K)
    buf = torch.zeros((n * C + 1, d), dtype=xf.dtype, device=xf.device)
    for k in range(K):
        buf = buf.index_add(0, dest_k[:, k], xf)
    return buf[:n * C].reshape(n, C, d)


def moe_drop_row_combine_ref(ye: torch.Tensor, gate: torch.Tensor,
                             dest: torch.Tensor, valid: torch.Tensor,
                             K: int) -> torch.Tensor:
    """The MoE layer's combine before the slot map: K gathers from the
    expert outputs ``ye`` (n·C, d) with a zero drop row appended, each
    weighted by the gate of a kept assignment in ye's dtype: (T, d)."""
    d, dt = ye.shape[1], ye.dtype
    T = gate.shape[0]
    y_flat = torch.cat([ye, torch.zeros((1, d), dtype=dt, device=ye.device)])
    dest_k, valid_k = dest.reshape(T, K), valid.reshape(T, K)
    y = torch.zeros((T, d), dtype=dt, device=ye.device)
    for k in range(K):
        w = (gate[:, k] * valid_k[:, k]).to(dt)[:, None]
        y = y + y_flat[dest_k[:, k]] * w
    return y


# ---------------------------------------------------------------- attention
#: the masked score, as the reference's (repro/models/ops.py)
ATTN_NEG_INF = -1e30


def attention_key_range(start_m: int, block_m: int, block_n: int, Sk: int,
                        causal: bool, window: int) -> tuple:
    """(lo, hi): the attention kernels' live key tiles for the query rows
    [start_m, start_m + block_m) start at lo, lo + block_n, ... below hi.
    Tiles wholly above the diagonal (``causal``) or wholly at or below
    ``qpos - window`` (``window`` > 0) are skipped."""
    lo, hi = 0, Sk
    if causal:
        hi = min(Sk, start_m + block_m)
    if window > 0:
        lo = max(start_m - window + 1, 0) // block_n * block_n
    return lo, hi


def attention_query_range(start_n: int, block_m: int, block_n: int,
                          Sq: int, causal: bool, window: int) -> tuple:
    """(lo, hi): the live query tiles of the keys [start_n, start_n +
    block_n), as :func:`attention_key_range`."""
    lo, hi = 0, Sq
    if causal:
        lo = start_n // block_m * block_m
    if window > 0:
        hi = min(Sq, start_n + block_n - 1 + window)
    return lo, hi


def _attn_live(m0, m1, n0, n1, causal: bool, window: int, device):
    """(m1 - m0, n1 - n0) bool: query m sees key n."""
    qpos = torch.arange(m0, m1, device=device)[:, None]
    kpos = torch.arange(n0, n1, device=device)[None, :]
    ok = torch.ones((m1 - m0, n1 - n0), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return ok


def _heads_first(x: torch.Tensor, G: int = 1) -> torch.Tensor:
    """(B, S, KV, D) as f32 (B, KV * G, S, D): head h reads KV head
    h // G."""
    return x.float().repeat_interleave(G, dim=2).transpose(1, 2)


def attention_blocked_ref(q, k, v, *, causal: bool = True, window: int = 0,
                          block_m: int = 128, block_n: int = 64):
    """The attention forward kernel's arithmetic, tile by tile.

    q (B, Sq, H, D) already scaled, k (B, Sk, KV, D), v (B, Sk, KV, Dv),
    H % KV == 0. For each query tile of ``block_m`` rows, the live key
    tiles of ``block_n`` keys (:func:`attention_key_range`) in order:
    s = q.k^T as f32 products of the inputs, masked to -1e30; running
    max m and sum l in f32, the accumulator rescaled by exp(m_old - m);
    p = exp(s - m) rounded to v's dtype once, against the running max of
    its tile, for the f32 product p.v. Returns (o in q's dtype, lse (B,
    H, Sq) f32 = m + log l, o32: the f32 normalised output)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, Dv = H // KV, v.shape[-1]
    kf, vf, qf = _heads_first(k, G), _heads_first(v, G), _heads_first(q)
    o32 = torch.empty((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for m0 in range(0, Sq, block_m):
        m1 = min(m0 + block_m, Sq)
        qt = qf[:, :, m0:m1]
        acc = torch.zeros((B, H, m1 - m0, Dv), dtype=torch.float32,
                          device=q.device)
        mx = torch.full((B, H, m1 - m0), ATTN_NEG_INF, device=q.device)
        l = torch.zeros((B, H, m1 - m0), device=q.device)
        lo, hi = attention_key_range(m0, block_m, block_n, Sk, causal,
                                     window)
        for n0 in range(lo, hi, block_n):
            n1 = min(n0 + block_n, Sk)
            s = qt @ kf[:, :, n0:n1].transpose(-1, -2)
            s = torch.where(_attn_live(m0, m1, n0, n1, causal, window,
                                       q.device), s,
                            torch.full((), ATTN_NEG_INF, device=q.device))
            m_new = torch.maximum(mx, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(mx - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vf[
                :, :, n0:n1]
            mx = m_new
        l = l.clamp_min(1e-20)
        o32[:, :, m0:m1] = acc / l[..., None]
        lse[:, :, m0:m1] = mx + torch.log(l)
    o32 = o32.transpose(1, 2).contiguous()
    return o32.to(q.dtype), lse, o32


def _split3_parts(x: torch.Tensor):
    """:func:`split3_bf16` of ``x`` as three f32 tensors of its shape."""
    return split3_bf16(x.reshape(-1)).float().reshape(3, *x.shape).unbind(0)


def _split2_parts(x: torch.Tensor):
    """f32 ``x`` as (hi, mid) = (bf16(x), bf16(x - hi)) in f32: x to 16
    significant bits."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def attention_blocked_bwd_ref(q, k, v, o32, lse, do, *, causal: bool = True,
                              window: int = 0, dq_tiles=(64, 64),
                              dkdv_tiles=(64, 64)):
    """The attention backward kernels' arithmetic, tile by tile: (dq, dk,
    dv) in the inputs' dtype from :func:`attention_blocked_ref`'s o32
    and lse and the output gradient ``do``.

    delta = rowsum(do * o32) in f32. dq, per query tile of ``dq_tiles``
    = (block_m, block_n) over its live key tiles: p = exp(s - lse) (0
    where masked), dp = do.v^T, ds = p (dp - delta), dq += hi.k + mid.k
    + lo.k with (hi, mid, lo) = split3_bf16(ds). dk and dv, per key tile
    of ``dkdv_tiles`` and KV head, over the G query heads of its group
    and their live query tiles (:func:`attention_query_range`): dv +=
    hi^T.do + mid^T.do with (hi, mid) = :func:`_split2_parts` of the
    normalised p (p itself for f32 inputs), dk += the split of ds^T
    times q. Every product is f32 of the inputs (exact for bf16), every
    sum f32; the three leave in q's, k's and v's dtype."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, Dv = H // KV, v.shape[-1]
    dev = q.device
    qf, dof = _heads_first(q), _heads_first(do)
    kf, vf = _heads_first(k), _heads_first(v)
    delta = (dof * o32.transpose(1, 2)).sum(-1)            # (B, H, Sq)
    zero = torch.zeros((), device=dev)
    dq = torch.empty((B, H, Sq, D), dtype=torch.float32, device=dev)
    bm, bn = dq_tiles
    for m0 in range(0, Sq, bm):
        m1 = min(m0 + bm, Sq)
        acc = torch.zeros((B, H, m1 - m0, D), dtype=torch.float32,
                          device=dev)
        lo, hi = attention_key_range(m0, bm, bn, Sk, causal, window)
        for n0 in range(lo, hi, bn):
            n1 = min(n0 + bn, Sk)
            kt = kf[:, :, n0:n1].repeat_interleave(G, dim=1)
            vt = vf[:, :, n0:n1].repeat_interleave(G, dim=1)
            s = qf[:, :, m0:m1] @ kt.transpose(-1, -2)
            p = torch.where(_attn_live(m0, m1, n0, n1, causal, window, dev),
                            torch.exp(s - lse[:, :, m0:m1, None]), zero)
            dp = dof[:, :, m0:m1] @ vt.transpose(-1, -2)
            for part in _split3_parts(p * (dp - delta[:, :, m0:m1, None])):
                acc = acc + part @ kt
        dq[:, :, m0:m1] = acc
    dk = torch.empty((B, KV, Sk, D), dtype=torch.float32, device=dev)
    dv = torch.empty((B, KV, Sk, Dv), dtype=torch.float32, device=dev)
    bm, bn = dkdv_tiles
    for n0 in range(0, Sk, bn):
        n1 = min(n0 + bn, Sk)
        kt, vt = kf[:, :, n0:n1], vf[:, :, n0:n1]
        dka = torch.zeros((B, KV, n1 - n0, D), device=dev)
        dva = torch.zeros((B, KV, n1 - n0, Dv), device=dev)
        lo, hi = attention_query_range(n0, bm, bn, Sq, causal, window)
        for g in range(G):
            heads = torch.arange(KV, device=dev) * G + g
            for m0 in range(lo, hi, bm):
                m1 = min(m0 + bm, Sq)
                qt = qf[:, heads, m0:m1]
                dot = dof[:, heads, m0:m1]
                sT = kt @ qt.transpose(-1, -2)
                ok = _attn_live(m0, m1, n0, n1, causal, window, dev).T
                pT = torch.where(ok, torch.exp(
                    sT - lse[:, heads, None, m0:m1]), zero)
                for part in (_split2_parts(pT) if v.dtype == torch.bfloat16
                             else (pT,)):
                    dva = dva + part @ dot
                dpT = vt @ dot.transpose(-1, -2)
                dsT = pT * (dpT - delta[:, heads, None, m0:m1])
                for part in _split3_parts(dsT):
                    dka = dka + part @ qt
        dk[:, :, n0:n1], dv[:, :, n0:n1] = dka, dva
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))
