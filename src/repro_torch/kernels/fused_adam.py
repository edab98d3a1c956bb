"""K3 ``adam_tile_update`` (``csrc/fused_adam.cu``), the port of
``repro.kernels.fused_adam``: a one-pass Adam update of a flat tensor
with the hyper row read from device memory. A tensor on the CPU goes to
the plain version in ``kernels.ref``; a CUDA tensor launches the kernel
or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_FLOATS = (torch.float32, torch.bfloat16)


def adam_tile_update(p, g, mu, nu, hyper):
    """p (f32/bf16), g (f32/bf16), mu, nu (f32), all one shape; hyper
    (1, 8) f32 = [lr, b1, b2, eps, c1, c2, -, -]. Returns (p', mu', nu')
    with p' in p's dtype."""
    if not p.is_cuda:
        return ref.adam_tile_update_ref(p, g, mu, nu, hyper)
    build.require_cuda(p, "p", dtypes=_FLOATS)
    build.require_cuda(g, "g", dtypes=_FLOATS)
    build.require_cuda(mu, "mu", dtypes=(torch.float32,))
    build.require_cuda(nu, "nu", dtypes=(torch.float32,))
    build.require_cuda(hyper, "hyper", dtypes=(torch.float32,), align=4)
    if not (p.shape == g.shape == mu.shape == nu.shape) \
            or hyper.numel() != 8:
        raise ValueError("adam_tile_update: shape mismatch")
    p2 = torch.empty_like(p)
    mu2 = torch.empty_like(mu)
    nu2 = torch.empty_like(nu)
    n = p.numel()
    if n:
        fn = build.entry("fused_adam", f"adam_update_p{build.dtype_tag(p.dtype)}"
                                       f"_g{build.dtype_tag(g.dtype)}")
        build.check(fn(hyper.data_ptr(), p.data_ptr(), g.data_ptr(),
                       mu.data_ptr(), nu.data_ptr(), p2.data_ptr(),
                       mu2.data_ptr(), nu2.data_ptr(), n,
                       build.stream_ptr(p.device)), "adam_tile_update")
        build.LAUNCHES["adam_tile_update"] += 1
    return p2, mu2, nu2
