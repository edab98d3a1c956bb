"""K4 ``topk_apply`` (``csrc/replay.cu``), the port of
``repro.kernels.replay.topk_apply``: decode a top-k differential's wire
form into an f32 gradient and apply one Adam step in one pass. The
port's lowdiff training step and its recovery replay both run it, on the
same payload, so a recovered state equals the trained one bit for bit.
A tensor on the CPU goes to the plain version in ``kernels.ref``; a CUDA
tensor launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

KERNEL_BLOCK = 1024
_FLOATS = (torch.float32, torch.bfloat16)


def topk_apply(vals, idx, p, mu, nu, hyper, *, block: int = KERNEL_BLOCK):
    """vals/idx (nb, k) over ``block``-element blocks of the flattened
    p/mu/nu (any one shape, nb = ceil(numel / block)); hyper (1, 8) f32
    = [lr, b1, b2, eps, c1, c2, 1-b1, 1-b2]. k may be 0 (g == 0).
    Returns (p', mu', nu') shaped like p, p' in p's dtype."""
    if not p.is_cuda:
        pb, _ = ref.to_blocks(p, block)
        mub, _ = ref.to_blocks(mu, block)
        nub, _ = ref.to_blocks(nu, block)
        rows = pb.shape[0]
        if vals.shape[0] != rows:
            raise ValueError("payload rows do not cover the leaf")
        p2, mu2, nu2 = ref.topk_apply_ref(vals, idx, pb, mub, nub, hyper,
                                          block=block)
        return (ref.unblock(p2, p.shape), ref.unblock(mu2, p.shape),
                ref.unblock(nu2, p.shape))
    build.require_cuda(p, "p", dtypes=_FLOATS)
    build.require_cuda(mu, "mu", dtypes=(torch.float32,))
    build.require_cuda(nu, "nu", dtypes=(torch.float32,))
    build.require_cuda(vals, "vals", dtypes=_FLOATS, align=4)
    build.require_cuda(idx, "idx", dtypes=(torch.int32,), align=4)
    build.require_cuda(hyper, "hyper", dtypes=(torch.float32,), align=4)
    if block != KERNEL_BLOCK:
        raise ValueError(f"CUDA topk_apply takes block={KERNEL_BLOCK}")
    n = p.numel()
    nb, k = vals.shape
    if not (p.shape == mu.shape == nu.shape) or hyper.numel() != 8 \
            or tuple(idx.shape) != (nb, k) or nb != -(-n // block):
        raise ValueError("topk_apply: shape mismatch")
    p2 = torch.empty_like(p)
    mu2 = torch.empty_like(mu)
    nu2 = torch.empty_like(nu)
    if n:
        fn = build.entry("replay", f"topk_apply_p{build.dtype_tag(p.dtype)}"
                                   f"_v{build.dtype_tag(vals.dtype)}")
        build.check(fn(hyper.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                       p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                       p2.data_ptr(), mu2.data_ptr(), nu2.data_ptr(), n, k,
                       build.stream_ptr(p.device)), "topk_apply")
        build.LAUNCHES["topk_apply"] += 1
    return p2, mu2, nu2
