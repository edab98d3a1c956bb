"""Attention as one blocked kernel on the card's tensor cores, forward
and backward (``csrc/attention_triton.py``; the design, the layout and
the precision are in that file's docstring). ``models/ops.py::attention``
runs :func:`attention` for bf16 tensors on the card; the CPU, the dry
run's fake tensors and an f32 compute dtype keep its plain body.

``attn_fwd`` launches ``attn_fwd_kernel``; ``attn_bwd`` launches
``attn_bwd_dq_kernel`` (which also forms delta) and then
``attn_bwd_dkdv_kernel``. Tiles and warps are fixed by the query/key
head width (:data:`TILES`): no knob and no autotuning, since a compile
counts in a run's set-up. A tensor on the CPU goes to the plain versions
(``kernels/ref.py::attention_blocked_ref`` and
``attention_blocked_bwd_ref``, with the same tiles); a CUDA tensor
launches the kernels or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: per kernel, (block_m query rows, block_n keys, warps, pipeline
#: stages), for query/key heads up to 64 wide and wider: the fastest of
#: 4-5 candidates each at the benchmark cells' shapes on an H100
TILES = {
    "narrow": {"fwd": (128, 64, 4, 3), "dq": (64, 64, 4, 3),
               "dkdv": (64, 64, 4, 3)},
    "wide": {"fwd": (64, 64, 4, 2), "dq": (64, 64, 4, 2),
             "dkdv": (32, 64, 4, 2)},
}


def tiles(d_qk: int) -> dict:
    return TILES["narrow" if d_qk <= 64 else "wide"]


def _pow2(n: int) -> int:
    return max(16, 1 << (n - 1).bit_length())


def head_split(d: int) -> tuple:
    """(DA, DB): the kernels take a head of width d as DA + DB columns,
    each a power of two of at least 16 (DB = 0 for one part), or as DA
    >= d with masked columns where d is no such sum."""
    if d >= 16 and d & (d - 1) == 0:
        return d, 0
    a = 1 << (d.bit_length() - 1)
    b = d - a
    if a >= 16 and b >= 16 and b & (b - 1) == 0:
        return a, b
    return _pow2(d), 0


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise TypeError(f"attention kernel: {name} must be a bf16 CUDA "
                            f"tensor, not {t.dtype} on {t.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"attention kernel: {name} {tuple(t.shape)} "
                             f"must be 4-D with unit stride along its last "
                             f"dim")
    B, Sq, H, D = q.shape
    if (k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]
            or H % k.shape[2]):
        raise ValueError(f"attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         f"(B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, Dv) "
                         f"with KV dividing H")


def _common(q, k, v, causal: bool, window: int) -> dict:
    D, DV = q.shape[3], v.shape[3]
    DA, DB = head_split(D)
    return dict(H=q.shape[2], G=q.shape[2] // k.shape[2], Sq=q.shape[1],
                Sk=k.shape[1], window=window, D=D, DA=DA, DB=DB, DV=DV,
                DVB=_pow2(DV), CAUSAL=bool(causal), WINDOW=window > 0)


def _launch(kernel, grid, tile, args, common, **const):
    bm, bn, warps, stages = tile
    kernel[grid](*args, **common, **const, BLOCK_M=bm, BLOCK_N=bn,
                 num_warps=warps, num_stages=stages, enable_fp_fusion=False)


def attn_fwd(q, k, v, causal: bool, window: int, keep_f32: bool):
    """(o, lse, o32): o (B, Sq, H, Dv) in q's dtype, lse (B, H, Sq) f32
    and, with ``keep_f32``, the f32 normalised output (else None)."""
    t = tiles(q.shape[3])
    if not q.is_cuda:
        o, lse, o32 = ref.attention_blocked_ref(
            q, k, v, causal=causal, window=window, block_m=t["fwd"][0],
            block_n=t["fwd"][1])
        return o, lse, (o32 if keep_f32 else None)
    _check(q, k, v)
    B, Sq, H, _ = q.shape
    DV = v.shape[3]
    o = torch.empty((B, Sq, H, DV), dtype=q.dtype, device=q.device)
    # without keep_f32 the kernel writes no o32: o stands in for the pointer
    o32 = (torch.empty((B, Sq, H, DV), dtype=torch.float32, device=q.device)
           if keep_f32 else o)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    kern = build.triton_module("attention_triton")
    _launch(kern.attn_fwd_kernel, (-(-Sq // t["fwd"][0]), B * H), t["fwd"],
            (q, k, v, o, o32, lse, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *o.stride()[:3]),
            _common(q, k, v, causal, window), STORE_F32=keep_f32)
    build.LAUNCHES["attn_fwd"] += 1
    return o, lse, (o32 if keep_f32 else None)


def attn_bwd(q, k, v, o32, lse, do, causal: bool, window: int):
    """(dq, dk, dv) in the inputs' dtype from the forward's o32 and lse
    and the output gradient ``do`` (the layout of o32)."""
    t = tiles(q.shape[3])
    if not q.is_cuda:
        return ref.attention_blocked_bwd_ref(
            q, k, v, o32, lse, do, causal=causal, window=window,
            dq_tiles=t["dq"][:2], dkdv_tiles=t["dkdv"][:2])
    _check(q, k, v)
    do = do.contiguous()
    if do.dtype != q.dtype or do.shape != o32.shape:
        raise ValueError(f"attention kernel: do {do.dtype} "
                         f"{tuple(do.shape)} must be {q.dtype} "
                         f"{tuple(o32.shape)}")
    B, Sq, H, _ = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, k.shape[3]), dtype=k.dtype,
                     device=k.device)
    dv = torch.empty((B, Sk, KV, v.shape[3]), dtype=v.dtype,
                     device=v.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    kern = build.triton_module("attention_triton")
    common = _common(q, k, v, causal, window)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *do.stride()[:3])
    _launch(kern.attn_bwd_dq_kernel, (-(-Sq // t["dq"][0]), B * H),
            t["dq"], (q, k, v, do, o32, lse, delta, dq, *strides), common)
    build.LAUNCHES["attn_bwd_dq"] += 1
    _launch(kern.attn_bwd_dkdv_kernel, (-(-Sk // t["dkdv"][1]), B * KV),
            t["dkdv"], (q, k, v, do, lse, delta, dk, dv, *strides), common)
    build.LAUNCHES["attn_bwd"] += 1
    return dq, dk, dv


class Attention(torch.autograd.Function):
    """:func:`attn_fwd` forward, :func:`attn_bwd` backward. Saves q, k, v,
    the f32 output and lse; under remat the recompute reruns the forward
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        keep = any(ctx.needs_input_grad[:3])
        o, lse, o32 = attn_fwd(q, k, v, causal, window, keep)
        if keep:
            ctx.save_for_backward(q, k, v, o32, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = attn_bwd(q, k, v, o32, lse, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention of scaled ``q`` (B, Sq, H, D) to k (B, Sk, KV, D) and v
    (B, Sk, KV, Dv): (B, Sq, H, Dv) in q's dtype. ``window`` > 0 lets
    query i see keys j > i - window; the kernels take Sq != Sk (cross
    attention, not causal there) and lengths of any size."""
    return Attention.apply(q, k, v, bool(causal), int(window or 0))
