"""K11 ``quantize`` and K12 ``dequantize`` (``csrc/quant8.cu``), the port
of ``repro.kernels.quant8``: blockwise absmax int8 quantization of a
gradient (the quant8 compressor) and its inverse.

Both wrappers take the flat tensor and its unpadded block count; the
kernels read the ragged tail of the last 1024-element block as zeros
(its codes come out 0). The scale is returned as (nb,), the shape
``QuantGrad`` keeps. A tensor on the CPU goes to the plain version in
``kernels.ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

KERNEL_BLOCK = 1024


def quantize(x: torch.Tensor, *, block: int = KERNEL_BLOCK):
    """``x`` (any shape, flattened) -> (q int8 (nb, block), scale f32
    (nb,))."""
    if not x.is_cuda:
        q, scale = ref.quantize_ref(ref.to_blocks(x, block)[0])
        return q, scale.reshape(-1)
    build.require_cuda(x, "x", dtypes=(torch.float32, torch.bfloat16))
    if block != KERNEL_BLOCK:
        raise ValueError(f"CUDA quantize takes block={KERNEL_BLOCK}")
    n = x.numel()
    nb = -(-n // block)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if n:
        fn = build.entry("quant8", f"quantize_{build.dtype_tag(x.dtype)}")
        build.check(fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), n,
                       build.stream_ptr(x.device)), "quantize")
        build.LAUNCHES["quantize"] += 1
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int, *,
               block: int = KERNEL_BLOCK) -> torch.Tensor:
    """Inverse of :func:`quantize`: the first ``n`` elements of
    f32(q) * scale, flat f32."""
    if not q.is_cuda:
        return ref.dequantize_ref(q, scale).reshape(-1)[:n]
    build.require_cuda(q, "q", dtypes=(torch.int8,), align=4)
    build.require_cuda(scale, "scale", dtypes=(torch.float32,), align=4)
    if block != KERNEL_BLOCK:
        raise ValueError(f"CUDA dequantize takes block={KERNEL_BLOCK}")
    nb = q.shape[0]
    if tuple(q.shape) != (nb, block) or scale.numel() != nb \
            or nb != -(-n // block):
        raise ValueError(f"payload {tuple(q.shape)}/{tuple(scale.shape)} "
                         f"does not cover {n} elements")
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n:
        fn = build.entry("quant8", "dequantize_f32")
        build.check(fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), n,
                       build.stream_ptr(q.device)), "dequantize")
        build.LAUNCHES["dequantize"] += 1
    return out
