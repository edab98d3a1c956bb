"""Shared numeric building blocks: norms, RoPE, attention (prefill and
single-token decode against a KV cache), the cache write, chunked xent.

Plain torch ops that mirror ``repro.models.ops`` op for op. Softmax
statistics are kept in f32 regardless of the compute dtype, and every
product the reference asks for with ``preferred_element_type=f32``
multiplies f32 up-casts of its (bf16) inputs: the products of two bf16
values are exact in f32 and the sum accumulates in f32, which is what
the reference computes — a bf16 product cast up afterwards is not.

The loss head takes the same argument onto the card's tensor cores: for
bf16 CUDA tensors :func:`chunked_softmax_xent` runs
:class:`_TensorCoreXent`, whose GEMMs multiply the bf16 operands
themselves with f32 accumulation and an f32 output (``aten::mm.dtype``)
— the same exact products, summed in f32 in another order — and whose
row kernels (``kernels/xent.py``, bound by bytes) read each chunk's f32
logits once. Its backward writes the f32 logit gradient as three bf16
terms whose sum is that gradient bit for bit, so it too enters the
backward's tensor-core GEMMs at f32 precision. The CPU, the dry run's
fake tensors and an f32 compute dtype keep the up-cast path
(:func:`_xent_upcast`).

Attention takes the same route: for bf16 CUDA tensors :func:`attention`
runs ``kernels/attention.py``, one blocked kernel for the forward and
two for the backward on tensor cores, with no (Sq, Sk) tile in device
memory; the CPU, fake tensors and f32 keep the plain body below.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import attention as attn_kernels
from repro_torch.kernels import xent

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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude factor ``0.1 * mscale * ln(factor) + 1`` (1 for
    ``factor`` <= 1)."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(dim: int, theta: float, s, device=None):
    """YaRN's inverse frequencies (dim/2,) of ``s`` (``YarnScaling``), as
    DeepSeek-V2 computes them: pair i keeps ``theta^(-2i/dim)`` below the
    correction range ``[lo, hi]`` (the pairs that turn ``beta_fast`` and
    ``beta_slow`` times over the original context, floored and ceiled),
    takes it divided by ``factor`` above it, and a linear ramp of the two
    between."""
    def corr(rotations):
        return dim * math.log(s.original_max_position
                              / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    lo = max(math.floor(corr(s.beta_fast)), 0)
    hi = min(math.ceil(corr(s.beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (s.factor * theta ** exps)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - lo) / (hi - lo), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def apply_rope(x, positions, theta: float, scaling=None):
    """x: (..., S, H, D); positions: broadcastable to (..., S).
    ``scaling``: a ``YarnScaling``, whose frequencies (:func:`yarn_freqs`)
    replace the plain ones and whose ``mscale / mscale_all_dim`` ratio
    multiplies cos and sin."""
    hd = x.shape[-1]
    if scaling is None:
        freqs = rope_freqs(hd, theta, x.device)
    else:
        freqs = yarn_freqs(hd, theta, scaling, x.device)
    ang = positions[..., None].float() * freqs          # (...,S,hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    if scaling is not None:
        a = yarn_mscale(scaling.factor, scaling.mscale) \
            / yarn_mscale(scaling.factor, scaling.mscale_all_dim)
        cos, sin = cos * a, sin * a
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v, *, causal=True, window=0, scale=None):
    """Causal GQA attention with an f32 masked softmax.

    q: (B, Sq, H, D); k: (B, Sk, KV, D), v: (B, Sk, KV, Dv) with H % KV
    == 0. q is scaled by ``scale`` (default ``1/sqrt(D)``) rounded to its
    dtype. bf16 tensors on the card go to the blocked kernels
    (``kernels/attention.py``: the reference's online softmax over key
    tiles, dead tiles skipped). Otherwise the reference's online softmax
    over one score tile (its tiles are 512 x 1024, so every sequence up
    to 512 is one tile) in plain ops: scores in f32, masked to NEG_INF,
    un-normalized probabilities cast to v's dtype for the value product,
    normalized by their f32 sum last. Returns (B, Sq, H, Dv).
    """
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    qr = q * as_dtype(scale, q.dtype)
    if _tensor_cores(q):
        return attn_kernels.attention(qr, k, v, causal=causal, window=window)
    return _attention_plain(qr, k, v, causal, window)


def _attention_plain(q, k, v, causal=True, window=0):
    """:func:`attention`'s plain body, of the scaled ``q``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, D)
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
    return out.reshape(B, Sq, H, v.shape[-1])


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


def _xent_upcast(h, w_lm, targets, mr, chunk, remat):
    """The plain head: f32 up-casts multiplied chunk by chunk, each chunk
    recomputed on backward when ``remat``."""
    S = h.shape[1]
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


def _xent_upcast_terms(h, w_lm, targets, mr, chunk, wrt):
    """The up-cast path's gradient of the mean loss with respect to the
    leaf ``wrt`` (``w_lm`` itself, or the tensor a tied head transposes)
    chunk by chunk, each in ``wrt``'s dtype, last chunk first: the terms
    autograd sums, in its order. For comparisons of the head's dW."""
    cnt = torch.clamp(mr.sum(), min=1.0)
    terms = []
    for i in reversed(range(0, h.shape[1], chunk)):
        lc, _ = _xent_chunk(h[:, i:i + chunk], targets[:, i:i + chunk],
                            mr[:, i:i + chunk], w_lm)
        terms.append(torch.autograd.grad(lc / cnt, [wrt])[0])
    return terms


def _mm_f32(a, b):
    """``a @ b`` of two bf16 matrices with f32 products and sums: on the
    card a tensor-core GEMM with an f32 output, on the CPU the same
    products of f32 up-casts."""
    if a.is_cuda:
        return torch.ops.aten.mm.dtype(a, b, torch.float32)
    return torch.mm(a.float(), b.float())


def _head_operand(w, dtype):
    """The head weight (D, V) in ``dtype``, as (D, V8) with V8 = V rounded
    up to 8 and zeros in the added columns, so that every logits row
    starts 32-byte aligned and the GEMMs get aligned leading dimensions;
    ``w`` itself (any strides, a tied head's transpose too) where it is
    in ``dtype`` already and V is a multiple of 8."""
    D, V = w.shape
    V8 = -(-V // 8) * 8
    if w.dtype == dtype and V8 == V:
        return w
    out = torch.empty((D, V8), dtype=dtype, device=w.device)
    out[:, :V].copy_(w)
    out[:, V:].zero_()
    return out


def _chunk_rows(h, targets, mr, i, chunk):
    """Chunk ``[i, i + chunk)`` of the sequence (shorter at its end when
    ``chunk`` does not divide S) as rows: h (R, D), targets (R,) int32,
    the mask (R,) f32, R = B * its length."""
    B, S, D = h.shape
    R = B * (min(i + chunk, S) - i)
    return (h[:, i:i + chunk].reshape(R, D),
            targets[:, i:i + chunk].reshape(R).to(torch.int32),
            mr[:, i:i + chunk].reshape(R).float())


class _TensorCoreXent(torch.autograd.Function):
    """The chunked head with bf16 tensor-core products (see the module
    docstring). Forward: per chunk, f32 logits from a bf16 GEMM, then
    ``xent_rows``; saves h, the head weight in the compute dtype (cast
    once a call) and each row's lse. Backward: per chunk, the logits
    again, ``xent_grad_split``'s planes G = [hi; mid; lo] (3R, V8), dh
    as the f32 sum of the three (R, D) blocks of G @ W^T, and dW =
    [h; h; h]^T @ G (K = 3R). Rounding points as in the up-cast path:
    dh leaves in h's dtype, each chunk's dW is rounded to the compute
    dtype and the chunks' dW are summed in the weight's dtype, last
    chunk first, as autograd sums them. The logits are recomputed
    whatever ``remat`` says."""

    @staticmethod
    def forward(ctx, h, w_lm, targets, mr, chunk):
        B, S, _ = h.shape
        V = w_lm.shape[1]
        w = _head_operand(w_lm, h.dtype)
        lse = torch.empty((B, S), dtype=torch.float32, device=h.device)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, S, chunk):
            hc, tc, mc = _chunk_rows(h, targets, mr, i, chunk)
            l, _, loss = xent.xent_rows(_mm_f32(hc, w), tc, mc, V)
            lse[:, i:i + chunk] = l.view(B, -1)
            tot = tot + loss.sum()
            cnt = cnt + mr[:, i:i + chunk].sum()
        ctx.save_for_backward(h, w, lse, targets, mr)
        ctx.chunk, ctx.V, ctx.w_dtype = chunk, V, w_lm.dtype
        ctx.mark_non_differentiable(cnt)
        return tot, cnt

    @staticmethod
    def backward(ctx, dtot, _dcnt):
        h, w, lse, targets, mr = ctx.saved_tensors
        chunk, V = ctx.chunk, ctx.V
        need_h, need_w = ctx.needs_input_grad[:2]
        B, S, D = h.shape
        dtot = dtot.float().reshape(1).contiguous()
        dh = torch.empty_like(h) if need_h else None
        dw = None
        for i in reversed(range(0, S, chunk)):
            hc, tc, mc = _chunk_rows(h, targets, mr, i, chunk)
            R = hc.shape[0]
            lc = lse[:, i:i + chunk].reshape(R)
            g = xent.xent_grad_split(_mm_f32(hc, w), lc, tc, mc, dtot, V)
            if need_h:
                d = _mm_f32(g, w.T)
                dh[:, i:i + chunk] = (d[:R] + (d[R:2 * R] + d[2 * R:])).view(
                    B, -1, D)
            if need_w:
                dwc = _mm_f32(torch.cat([hc, hc, hc]).T, g)[:, :V]
                dwc = dwc.to(h.dtype).to(ctx.w_dtype)
                dw = dwc if dw is None else dw.add_(dwc)
        return dh, dw, None, None, None


def _tensor_cores(x) -> bool:
    """The head and attention run on tensor cores for ``x`` bf16 on the
    card, and not for the dry run's fake tensors."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        return False
    from torch._subclasses.fake_tensor import is_fake
    return not is_fake(x)


def chunked_softmax_xent(h, w_lm, targets, *, chunk=512, mask=None,
                         remat=True):
    """Cross-entropy without materializing (B, S, V) logits.

    h: (B, S, D) final hidden; w_lm: (D, V); targets: (B, S) int32.
    Returns (sum_loss, n_tokens). Chunks are recomputed on backward.
    bf16 ``h`` on the card goes through :class:`_TensorCoreXent`;
    anything else through the up-cast path. (f16 stays there too: its
    five exponent bits cannot hold the three-term split of a gradient.)
    """
    B, S, D = h.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    mr = (mask if mask is not None
          else torch.ones(targets.shape, dtype=torch.float32,
                          device=h.device))
    if _tensor_cores(h):
        return _TensorCoreXent.apply(h, w_lm, targets, mr, chunk)
    return _xent_upcast(h, w_lm, targets, mr, chunk, remat)


def as_dtype(v: float, dtype) -> float:
    """A python scalar rounded to ``dtype`` first, as JAX rounds a weakly
    typed scalar to the array's dtype before ``x * v`` or ``x / v``
    (torch would apply it in f32 to a bf16 tensor)."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def sqrt_scale(d_model: int, dtype) -> float:
    """``jnp.asarray(np.sqrt(d), dtype)`` as a python float: the scale
    rounded to the compute dtype first, as the reference rounds it."""
    return as_dtype(math.sqrt(d_model), dtype)
