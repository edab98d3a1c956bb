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

from repro_torch.compression.packed import PackedDiff
from repro_torch.compression.quant import QuantGrad
from repro_torch.compression.sparse import BLOCK, SparseGrad, k_for
from repro_torch.kernels import fused_adam as _fa
from repro_torch.kernels import pack as _pk
from repro_torch.kernels import quant8 as _q8
from repro_torch.kernels import replay as _rp
from repro_torch.kernels import span as _sp
from repro_torch.kernels import topk as _tk
from repro_torch.kernels.ref import to_blocks as _to_blocks  # noqa: F401
from repro_torch.optim.adam import bias_corrections


def topk_compress(x: torch.Tensor, rho: float, *,
                  block: int = BLOCK) -> SparseGrad:
    vals, idx = _tk.topk_select(x, k_for(rho, block), block=block)
    return SparseGrad(vals, idx, tuple(x.shape), block)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def topk_decompress(sg: SparseGrad) -> torch.Tensor:
    return _tk.topk_scatter(sg.values, sg.indices, _numel(sg.shape),
                            block=sg.block).reshape(sg.shape)


def packed_compress(x: torch.Tensor, rho: float, *,
                    block: int = BLOCK) -> PackedDiff:
    """Top-k + int8 quantize + wire pack in one pass (K8): the payload
    comes off the device in the frame serializer's layout."""
    q, idx, scale = _pk.pack_select(x, k_for(rho, block), block=block)
    return PackedDiff(q, idx, scale, tuple(x.shape), block)


def packed_decompress(pd: PackedDiff) -> torch.Tensor:
    """Inverse of :func:`packed_compress` (K9): dense f32."""
    return _pk.pack_scatter(pd.q, pd.indices, pd.scale, _numel(pd.shape),
                            block=pd.block).reshape(pd.shape)


def quant_compress(x: torch.Tensor, *, block: int = BLOCK) -> QuantGrad:
    """Blockwise absmax int8 (K11)."""
    q, scale = _q8.quantize(x, block=block)
    return QuantGrad(q, scale, tuple(x.shape), block)


def quant_decompress(qg: QuantGrad) -> torch.Tensor:
    """Inverse of :func:`quant_compress` (K12): dense f32."""
    return _q8.dequantize(qg.q, qg.scale, _numel(qg.shape),
                          block=qg.block).reshape(qg.shape)


def quant_span_encode(x2d: torch.Tensor, *, bits: int):
    """Quantize an (n, cols) row block with per-row absmax scales (K5):
    (q (n, wire_cols), scale (n, 1) f32), the bytes ``encode_rows``
    gives."""
    return _sp.span_pack(x2d, bits)


def quant_span_decode(q: torch.Tensor, scale: torch.Tensor, *, cols: int,
                      bits: int) -> torch.Tensor:
    """Inverse of :func:`quant_span_encode` (K6): dense f32 (n, cols)."""
    return _sp.quant_span_decode(q, scale, cols, bits)


def fused_span_apply(dst: torch.Tensor, start: int, q: torch.Tensor,
                     scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Dequantize one row-span payload into rows [start, start + n) of
    the state leaf ``dst`` (K7), in place; returns ``dst``."""
    return _sp.quant_span_apply(q, scale, dst, start, bits)


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


def _check_shape(payload, p) -> None:
    if tuple(payload.shape) != tuple(p.shape):
        raise ValueError(f"differential shape {tuple(payload.shape)} != "
                         f"leaf shape {tuple(p.shape)}")


def fused_sparse_apply(sg: SparseGrad, p, mu, nu, hyper):
    """Scatter the wire (values, indices) straight into the Adam update
    (K4): no dense gradient outside the kernel's accumulator."""
    _check_shape(sg, p)
    return _rp.topk_apply(sg.values, sg.indices, p, mu, nu, hyper,
                          block=sg.block)


def fused_packed_apply(pd: PackedDiff, p, mu, nu, hyper):
    """Dequantize + scatter + Adam in one pass over a packed payload
    (K10)."""
    _check_shape(pd, p)
    return _rp.packed_apply(pd.q, pd.indices, pd.scale, p, mu, nu, hyper,
                            block=pd.block)


def fused_quant_apply(qg: QuantGrad, p, mu, nu, hyper):
    """Dequantize the int8 blocks inside the Adam pass (K13)."""
    _check_shape(qg, p)
    return _rp.quant_apply(qg.q, qg.scale, p, mu, nu, hyper, block=qg.block)


def fused_adam_update(p, g, mu, nu, hyper):
    """Dense one-pass Adam (K3). Shapes all equal; returns (p', mu', nu')."""
    return _fa.adam_tile_update(p, g, mu, nu, hyper)


def fused_decode_apply(payload, p, mu, nu, hyper):
    """Apply one differential leaf to (p, mu, nu), dispatching on its
    wire container: top-k through K4, packed through K10, quant8 through
    K13, a dense gradient through K3."""
    if isinstance(payload, SparseGrad):
        return fused_sparse_apply(payload, p, mu, nu, hyper)
    if isinstance(payload, PackedDiff):
        return fused_packed_apply(payload, p, mu, nu, hyper)
    if isinstance(payload, QuantGrad):
        return fused_quant_apply(payload, p, mu, nu, hyper)
    return fused_adam_update(p, payload, mu, nu, hyper)
