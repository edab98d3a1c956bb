"""K8 ``pack_select`` and K9 ``pack_scatter`` (``csrc/topk.cu``), the
port of ``repro.kernels.pack.pack_select`` / ``pack_scatter``: blockwise
top-k with the picks quantized to int8 against the block's absmax (the
packed compressor), and its dequantizing scatter back to dense f32.

K8 is K1's selection kernel with a quantize epilogue (a template flag),
so it picks the indices K1 picks. Both wrappers take the flat tensor and
its unpadded block count; the kernels read the ragged tail of the last
1024-element block as zeros. A tensor on the CPU goes to the plain
version in ``kernels.ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

KERNEL_BLOCK = 1024


def pack_select(x: torch.Tensor, k: int, *, block: int = KERNEL_BLOCK):
    """Blockwise top-k of ``x`` (any shape, flattened), quantized:
    returns (q int8 (nb, k), int32 block-local indices (nb, k), scale f32
    (nb, 1))."""
    if not x.is_cuda:
        xb, _ = ref.to_blocks(x, block)
        return ref.pack_select_ref(xb, k)
    build.require_cuda(x, "x", dtypes=(torch.float32, torch.bfloat16))
    if block != KERNEL_BLOCK:
        raise ValueError(f"CUDA pack_select takes block={KERNEL_BLOCK}")
    if not 1 <= k <= block:
        raise ValueError(f"k must be in [1, {block}], got {k}")
    n = x.numel()
    nb = -(-n // block)
    q = torch.empty((nb, k), dtype=torch.int8, device=x.device)
    idx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    if n:
        fn = build.entry("topk", f"pack_select_{build.dtype_tag(x.dtype)}")
        build.check(fn(x.data_ptr(), q.data_ptr(), idx.data_ptr(),
                       scale.data_ptr(), n, k, build.stream_ptr(x.device)),
                    "pack_select")
        build.LAUNCHES["pack_select"] += 1
    return q, idx, scale


def pack_scatter(q: torch.Tensor, idx: torch.Tensor, scale: torch.Tensor,
                 n: int, *, block: int = KERNEL_BLOCK) -> torch.Tensor:
    """Inverse of :func:`pack_select`: the dense flat f32 tensor (n,)."""
    if not q.is_cuda:
        dense = ref.pack_scatter_ref(q, idx, scale, block)
        return dense.reshape(-1)[:n]
    build.require_cuda(q, "q", dtypes=(torch.int8,), align=1)
    build.require_cuda(idx, "idx", dtypes=(torch.int32,), align=4)
    build.require_cuda(scale, "scale", dtypes=(torch.float32,), align=4)
    if block != KERNEL_BLOCK:
        raise ValueError(f"CUDA pack_scatter takes block={KERNEL_BLOCK}")
    nb, k = q.shape
    if tuple(idx.shape) != (nb, k) or scale.numel() != nb \
            or nb != -(-n // block):
        raise ValueError(f"payload {tuple(q.shape)}/{tuple(idx.shape)}/"
                         f"{tuple(scale.shape)} does not cover {n} elements")
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n:
        fn = build.entry("topk", "pack_scatter_f32")
        build.check(fn(q.data_ptr(), idx.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), n, k, build.stream_ptr(q.device)),
                    "pack_scatter")
        build.LAUNCHES["pack_scatter"] += 1
    return out
