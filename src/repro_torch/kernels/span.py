"""K5 ``span_pack``, K6 ``quant_span_decode`` and K7 ``quant_span_apply``
(``csrc/span.cu``), the port of ``repro.kernels.pack.span_pack`` and
``repro.kernels.replay.quant_span_decode`` / ``quant_span_apply``: the
per-row absmax int8/int4 codec of LowDiff+'s quantized row-span patches,
bit-identical to the numpy codec (``compression.quant_span``). A tensor
on the CPU goes to the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises.

The kernels handle any row count and odd ``cols`` themselves; the
reference pads rows to its 8-row Pallas tile and int4 columns to even
first, and slices the padding off again.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_WIRE = {8: torch.int8, 4: torch.uint8}


def _check_bits(bits: int) -> None:
    if bits not in _WIRE:
        raise ValueError(f"bits must be 8 or 4, not {bits}")


def wire_cols(cols: int, bits: int) -> int:
    return cols if bits == 8 else (cols + 1) // 2


def span_pack(x2d: torch.Tensor, bits: int):
    """Quantize an (n, cols) f32 row block with per-row absmax scales ->
    (q (n, wire_cols) int8 | uint8, scale (n, 1) f32)."""
    _check_bits(bits)
    if x2d.dim() != 2:
        raise ValueError(
            f"span_pack takes (n, cols), not {tuple(x2d.shape)}")
    if not x2d.is_cuda:
        return ref.span_pack_ref(x2d, bits)
    build.require_cuda(x2d, "x2d", dtypes=(torch.float32,), align=4)
    n, cols = x2d.shape
    q = torch.empty((n, wire_cols(cols, bits)), dtype=_WIRE[bits],
                    device=x2d.device)
    scale = torch.empty((n, 1), dtype=torch.float32, device=x2d.device)
    if n and cols:
        amax = torch.zeros(n, dtype=torch.int32, device=x2d.device)
        fn = build.entry("span", "span_pack")
        build.check(fn(x2d.data_ptr(), q.data_ptr(), scale.data_ptr(),
                       amax.data_ptr(), n, cols, bits,
                       build.stream_ptr(x2d.device)), "span_pack")
        build.LAUNCHES["span_pack"] += 1
    else:
        scale.fill_(1e-12)
    return q, scale


def _check_wire(q, scale, cols: int, bits: int) -> None:
    _check_bits(bits)
    if q.dim() != 2 or q.dtype != _WIRE[bits]:
        raise TypeError(f"int{bits} span payload must be a 2-d "
                        f"{_WIRE[bits]} tensor, not {q.dtype}{tuple(q.shape)}")
    n, wc = q.shape
    if scale.numel() != n or scale.dtype != torch.float32:
        raise ValueError(f"scale {scale.dtype}{tuple(scale.shape)} does "
                         f"not give one f32 per row of {n}")
    if cols < 0 or wire_cols(cols, bits) > wc:
        raise ValueError(f"{wc} wire columns cannot hold {cols} int{bits} "
                         f"columns")


def quant_span_decode(q: torch.Tensor, scale: torch.Tensor, cols: int,
                      bits: int) -> torch.Tensor:
    """Wire bytes + per-row scales -> dense f32 (n, cols)."""
    _check_wire(q, scale, cols, bits)
    if not q.is_cuda:
        return ref.span_decode_ref(q, scale, cols, bits)
    build.require_cuda(q, "q", align=1)
    build.require_cuda(scale, "scale", align=4)
    n, wc = q.shape
    out = torch.empty((n, cols), dtype=torch.float32, device=q.device)
    if n and cols:
        fn = build.entry("span", "span_decode")
        build.check(fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), n,
                       cols, wc, bits, build.stream_ptr(q.device)),
                    "quant_span_decode")
        build.LAUNCHES["quant_span_decode"] += 1
    return out


def quant_span_apply(q: torch.Tensor, scale: torch.Tensor,
                     dst: torch.Tensor, start: int, bits: int) -> torch.Tensor:
    """Dequantize one row-span payload straight into rows [start,
    start + n) of the state leaf ``dst`` (shape (N, *tail), f32 or bf16),
    cast to its dtype. Writes **in place** and returns ``dst``: the
    reference returns a new array from ``dynamic_update_slice``; the port
    updates the leaf, so recovery holds one copy of it."""
    if dst.dim() == 0:
        raise ValueError("quant_span_apply needs a leaf with a row axis")
    cols = 1
    for d in dst.shape[1:]:
        cols *= int(d)
    _check_wire(q, scale, cols, bits)
    n = q.shape[0]
    start = int(start)
    if start < 0 or start + n > dst.shape[0]:
        raise ValueError(f"rows [{start}, {start + n}) exceed the leaf's "
                         f"{dst.shape[0]} rows")
    if not dst.is_cuda:
        return ref.quant_span_apply_ref(q, scale, dst, start, bits=bits)
    build.require_cuda(dst, "dst", dtypes=(torch.float32, torch.bfloat16),
                       align=2)
    build.require_cuda(q, "q", align=1)
    build.require_cuda(scale, "scale", align=4)
    if n and cols:
        fn = build.entry("span", f"span_apply_{build.dtype_tag(dst.dtype)}")
        build.check(fn(q.data_ptr(), scale.data_ptr(), dst.data_ptr(), n,
                       cols, q.shape[1], start, bits,
                       build.stream_ptr(dst.device)), "quant_span_apply")
        build.LAUNCHES["quant_span_apply"] += 1
    return dst
