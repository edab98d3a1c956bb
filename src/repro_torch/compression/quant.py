"""Blockwise int8 quantization, the paper's other compression family
(port of ``repro.compression.quant``).

Per 1024-element block of the flattened tensor: ``scale = max(absmax *
f32(1/127), 1e-12)`` and ``q = clip(rint(x / scale), -127, 127)``. The
scale is a reciprocal multiply because that is what the reference
computes under ``jax.jit`` (XLA rewrites its ``/ 127.0``); the quotient
is a true division. Compress runs ``quantize`` (K11) and decompress
``dequantize`` (K12): the CUDA kernels for a tensor on the card, their
plain versions for a tensor on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch import register_node
from repro_torch.compression.sparse import BLOCK, _nbytes


@dataclasses.dataclass
class QuantGrad:
    q: Any                       # (nb, block) int8
    scale: Any                   # (nb,) f32
    shape: Tuple[int, ...]       # original dense shape
    block: int = BLOCK

    @property
    def nbytes(self) -> int:
        return _nbytes(self.q, 1) + _nbytes(self.scale, 4)

    def dense(self):
        return quant_decompress(self)


register_node(QuantGrad,
              lambda s: [s.q, s.scale],
              lambda s, kids: QuantGrad(kids[0], kids[1], s.shape, s.block))


def quant_compress(x, *, block: int = BLOCK) -> QuantGrad:
    from repro_torch.kernels import ops
    return ops.quant_compress(x, block=block)


def quant_decompress(qg: QuantGrad):
    from repro_torch.kernels import ops
    return ops.quant_decompress(qg)
