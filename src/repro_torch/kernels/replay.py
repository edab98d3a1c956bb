"""K4 ``topk_apply``, K10 ``packed_apply`` and K13 ``quant_apply``
(``csrc/replay.cu``), the port of ``repro.kernels.replay``'s fused
decode-and-apply kernels: decode a differential's wire form (top-k,
packed int8 top-k, or dense quant8) into an f32 gradient and apply one
Adam step in one pass. The port's lowdiff training step and its recovery
replay both run the compressor's kernel, on the same payload, so a
recovered state equals the trained one bit for bit. A tensor on the CPU
goes to the plain version in ``kernels.ref``; a CUDA tensor launches the
kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

KERNEL_BLOCK = 1024
_FLOATS = (torch.float32, torch.bfloat16)


def _plain(fn, p, mu, nu, rows: int, block: int):
    """Run plain version ``fn(pb, mub, nub)`` on the blocked state."""
    pb, _ = ref.to_blocks(p, block)
    mub, _ = ref.to_blocks(mu, block)
    nub, _ = ref.to_blocks(nu, block)
    if rows != pb.shape[0]:
        raise ValueError("payload rows do not cover the leaf")
    return tuple(ref.unblock(t, p.shape) for t in fn(pb, mub, nub))


def _launch(name: str, symbol: str, wires, p, mu, nu, hyper, rows: int,
            block: int, *extra):
    """Check the state and launch ``symbol`` with ``hyper, *wires, p, mu,
    nu, p', mu', nu', n, *extra``; returns (p', mu', nu')."""
    build.require_cuda(p, "p", dtypes=_FLOATS)
    build.require_cuda(mu, "mu", dtypes=(torch.float32,))
    build.require_cuda(nu, "nu", dtypes=(torch.float32,))
    build.require_cuda(hyper, "hyper", dtypes=(torch.float32,), align=4)
    if block != KERNEL_BLOCK:
        raise ValueError(f"CUDA {name} takes block={KERNEL_BLOCK}")
    n = p.numel()
    if not (p.shape == mu.shape == nu.shape) or hyper.numel() != 8 \
            or rows != -(-n // block):
        raise ValueError(f"{name}: shape mismatch")
    p2 = torch.empty_like(p)
    mu2 = torch.empty_like(mu)
    nu2 = torch.empty_like(nu)
    if n:
        fn = build.entry("replay", symbol)
        build.check(fn(hyper.data_ptr(), *(w.data_ptr() for w in wires),
                       p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                       p2.data_ptr(), mu2.data_ptr(), nu2.data_ptr(), n,
                       *extra, build.stream_ptr(p.device)), name)
        build.LAUNCHES[name] += 1
    return p2, mu2, nu2


def topk_apply(vals, idx, p, mu, nu, hyper, *, block: int = KERNEL_BLOCK):
    """vals/idx (nb, k) over ``block``-element blocks of the flattened
    p/mu/nu (any one shape, nb = ceil(numel / block)); hyper (1, 8) f32
    = [lr, b1, b2, eps, c1, c2, 1-b1, 1-b2]. k may be 0 (g == 0).
    Returns (p', mu', nu') shaped like p, p' in p's dtype."""
    if not p.is_cuda:
        return _plain(lambda pb, mub, nub: ref.topk_apply_ref(
            vals, idx, pb, mub, nub, hyper, block=block),
            p, mu, nu, vals.shape[0], block)
    build.require_cuda(vals, "vals", dtypes=_FLOATS, align=4)
    build.require_cuda(idx, "idx", dtypes=(torch.int32,), align=4)
    nb, k = vals.shape
    if tuple(idx.shape) != (nb, k):
        raise ValueError("topk_apply: shape mismatch")
    return _launch("topk_apply",
                   f"topk_apply_p{build.dtype_tag(p.dtype)}"
                   f"_v{build.dtype_tag(vals.dtype)}",
                   (vals, idx), p, mu, nu, hyper, nb, block, k)


def packed_apply(q, idx, scale, p, mu, nu, hyper, *,
                 block: int = KERNEL_BLOCK):
    """K4 on a packed payload: values f32(q) * scale. q int8 / idx int32
    (nb, k), scale f32 nb (any shape); k may be 0 (g == 0)."""
    if not p.is_cuda:
        return _plain(lambda pb, mub, nub: ref.packed_apply_ref(
            q, idx, scale, pb, mub, nub, hyper, block=block),
            p, mu, nu, q.shape[0], block)
    build.require_cuda(q, "q", dtypes=(torch.int8,), align=1)
    build.require_cuda(idx, "idx", dtypes=(torch.int32,), align=4)
    build.require_cuda(scale, "scale", dtypes=(torch.float32,), align=4)
    nb, k = q.shape
    if tuple(idx.shape) != (nb, k) or scale.numel() != nb:
        raise ValueError("packed_apply: shape mismatch")
    return _launch("packed_apply",
                   f"packed_apply_p{build.dtype_tag(p.dtype)}",
                   (q, idx, scale), p, mu, nu, hyper, nb, block, k)


def quant_apply(q, scale, p, mu, nu, hyper, *, block: int = KERNEL_BLOCK):
    """Adam on the dense quant8 payload g = f32(q) * scale. q int8 (nb,
    block), scale f32 nb (any shape)."""
    if not p.is_cuda:
        return _plain(lambda pb, mub, nub: ref.quant_apply_ref(
            q, scale, pb, mub, nub, hyper), p, mu, nu, q.shape[0], block)
    build.require_cuda(q, "q", dtypes=(torch.int8,), align=4)
    build.require_cuda(scale, "scale", dtypes=(torch.float32,), align=4)
    nb = q.shape[0]
    if tuple(q.shape) != (nb, block) or scale.numel() != nb:
        raise ValueError("quant_apply: shape mismatch")
    return _launch("quant_apply",
                   f"quant_apply_p{build.dtype_tag(p.dtype)}",
                   (q, scale), p, mu, nu, hyper, nb, block)
