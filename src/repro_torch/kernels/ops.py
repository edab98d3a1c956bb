"""Public entry points over the port's kernels (``repro.kernels.ops``).

Each call goes to the CUDA kernel for a tensor on the card and to the
kernel's plain-torch version (``kernels.ref``) for a tensor on the CPU
— the choice is made by the tensor's device inside the kernel wrapper,
never by a failed build or launch. Also here: the Adam hyper rows and
``fused_decode_apply``, the per-leaf apply step shared by the lowdiff
training step and both recovery replays.
"""
from __future__ import annotations

import torch

from repro_torch.compression.sparse import BLOCK, SparseGrad, k_for
from repro_torch.kernels import fused_adam as _fa
from repro_torch.kernels import replay as _rp
from repro_torch.kernels import topk as _tk
from repro_torch.kernels.ref import to_blocks as _to_blocks  # noqa: F401
from repro_torch.optim.adam import bias_corrections


def topk_compress(x: torch.Tensor, rho: float, *,
                  block: int = BLOCK) -> SparseGrad:
    vals, idx = _tk.topk_select(x, k_for(rho, block), block=block)
    return SparseGrad(vals, idx, tuple(x.shape), block)


def topk_decompress(sg: SparseGrad) -> torch.Tensor:
    n = 1
    for d in sg.shape:
        n *= int(d)
    return _tk.topk_scatter(sg.values, sg.indices, n,
                            block=sg.block).reshape(sg.shape)


def adam_hyper_traced(lr, b1, b2, eps, count: torch.Tensor) -> torch.Tensor:
    """The (1, 8) f32 hyper row [lr, b1, b2, eps, c1, c2, 1-b1, 1-b2] for
    the post-increment step ``count`` (a device tensor), built with
    device ops only, so the step and replay loops never synchronize with
    the host. The bias corrections are computed as ``adam_update``
    computes them; the moment complements are rounded from python
    doubles, as ``adam_update``'s scalar promotion rounds them."""
    c1, c2 = bias_corrections(b1, b2, count)
    key = (float(lr), float(b1), float(b2), float(eps), str(count.device))
    const = _CONSTS.get(key)
    if const is None:   # one host->device copy per hyperparameter set
        const = _CONSTS[key] = torch.tensor(
            [lr, b1, b2, eps, 1.0 - b1, 1.0 - b2], dtype=torch.float32,
            device=count.device)
    return torch.cat([const[:4], c1.reshape(1), c2.reshape(1),
                      const[4:]]).reshape(1, 8)


_CONSTS: dict = {}


def fused_sparse_apply(sg: SparseGrad, p, mu, nu, hyper):
    """Scatter the wire (values, indices) straight into the Adam update
    (K4): no dense gradient outside the kernel's accumulator."""
    if tuple(sg.shape) != tuple(p.shape):
        raise ValueError(f"differential shape {tuple(sg.shape)} != leaf "
                         f"shape {tuple(p.shape)}")
    return _rp.topk_apply(sg.values, sg.indices, p, mu, nu, hyper,
                          block=sg.block)


def fused_adam_update(p, g, mu, nu, hyper):
    """Dense one-pass Adam (K3). Shapes all equal; returns (p', mu', nu')."""
    return _fa.adam_tile_update(p, g, mu, nu, hyper)


def fused_decode_apply(payload, p, mu, nu, hyper):
    """Apply one differential leaf to (p, mu, nu): a top-k payload through
    K4, a dense gradient through K3."""
    if isinstance(payload, SparseGrad):
        return fused_sparse_apply(payload, p, mu, nu, hyper)
    return fused_adam_update(p, payload, mu, nu, hyper)
