"""Wire-format packed differential: blockwise top-k + int8 quantization
(port of ``repro.compression.packed``).

Per 1024-element block: the k entries of largest magnitude (ties to the
lowest index), quantized to int8 against the block's absmax — the first
pick — with ``scale = max(|v0| * f32(1/127), 1e-12)``, plus their
block-local indices. Compress runs ``pack_select`` (K8), ``dense()``
runs ``pack_scatter`` (K9). On disk the indices travel as int16
(block-local, < 1024), which is what ``nbytes`` counts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch import register_node
from repro_torch.compression.sparse import BLOCK, _nbytes


@dataclasses.dataclass
class PackedDiff:
    q: Any                       # (nb, k) int8, quantized top-k values
    indices: Any                 # (nb, k) int32, block-local
    scale: Any                   # (nb, 1) f32 per-block dequant scale
    shape: Tuple[int, ...]       # original dense shape
    block: int = BLOCK

    @property
    def nbytes(self) -> int:
        # indices fit in int16 on disk (block-local < 1024)
        return (_nbytes(self.q, 1) + _nbytes(self.indices, 2)
                + _nbytes(self.scale, 4))

    def dense(self):
        from repro_torch.kernels import ops
        return ops.packed_decompress(self)


register_node(PackedDiff,
              lambda s: [s.q, s.indices, s.scale],
              lambda s, kids: PackedDiff(kids[0], kids[1], kids[2], s.shape,
                                         s.block))
