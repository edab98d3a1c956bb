"""K1 ``topk_select`` and K2 ``topk_scatter`` (``csrc/topk.cu``), the
port of ``repro.kernels.topk``.

Both wrappers take the flat tensor and its unpadded block count: the
CUDA kernels read the ragged tail of the last 1024-element block as
zeros themselves, so no padded copy of the gradient is made. A tensor
on the CPU goes to the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

KERNEL_BLOCK = 1024     # the CUDA kernels' compression block


def _nb(n: int, block: int) -> int:
    return -(-n // block)


def topk_select(x: torch.Tensor, k: int, *, block: int = KERNEL_BLOCK):
    """Blockwise top-k of ``x`` (any shape, flattened): returns
    (values (nb, k) in x.dtype, int32 block-local indices (nb, k))."""
    if not x.is_cuda:
        xb, _ = ref.to_blocks(x, block)
        return ref.topk_select_ref(xb, k)
    build.require_cuda(x, "x", dtypes=(torch.float32, torch.bfloat16))
    if block != KERNEL_BLOCK:
        raise ValueError(f"CUDA topk_select takes block={KERNEL_BLOCK}")
    if not 1 <= k <= block:
        raise ValueError(f"k must be in [1, {block}], got {k}")
    n = x.numel()
    nb = _nb(n, block)
    vals = torch.empty((nb, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    if n:
        fn = build.entry("topk", f"topk_select_{build.dtype_tag(x.dtype)}")
        build.check(fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), n, k,
                       build.stream_ptr(x.device)), "topk_select")
        build.LAUNCHES["topk_select"] += 1
    return vals, idx


def topk_scatter(vals: torch.Tensor, idx: torch.Tensor, n: int, *,
                 block: int = KERNEL_BLOCK) -> torch.Tensor:
    """Inverse of :func:`topk_select`: the dense flat tensor (n,) in
    vals.dtype."""
    if not vals.is_cuda:
        dense = ref.topk_scatter_ref(vals, idx, block)
        return dense.reshape(-1)[:n]
    build.require_cuda(vals, "vals", dtypes=(torch.float32, torch.bfloat16),
                       align=4)
    build.require_cuda(idx, "idx", dtypes=(torch.int32,), align=4)
    if block != KERNEL_BLOCK:
        raise ValueError(f"CUDA topk_scatter takes block={KERNEL_BLOCK}")
    nb, k = vals.shape
    if tuple(idx.shape) != (nb, k) or nb != _nb(n, block):
        raise ValueError(f"payload {tuple(vals.shape)}/{tuple(idx.shape)} "
                         f"does not cover {n} elements")
    out = torch.empty((n,), dtype=vals.dtype, device=vals.device)
    if n:
        fn = build.entry("topk",
                         f"topk_scatter_{build.dtype_tag(vals.dtype)}")
        build.check(fn(vals.data_ptr(), idx.data_ptr(), out.data_ptr(), n, k,
                       build.stream_ptr(vals.device)), "topk_scatter")
        build.LAUNCHES["topk_scatter"] += 1
    return out
