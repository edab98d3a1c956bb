"""Blockwise top-k gradient sparsification (port of
``repro.compression.sparse``).

Selection is block-local: each 1024-element block of the flattened
tensor keeps its own top-k by magnitude, ties to the lowest index. The
representation is a ``SparseGrad`` per tensor: values (nb, k) in the
input dtype and int32 block-local indices (nb, k), with the unpadded
block count nb = ceil(numel / block) — the zero tail of the last block
takes part in the selection as the reference's padding does.

Compress and decompress run the port's kernels (``kernels.ops``): the
CUDA kernels for a tensor on the card, their plain-torch versions for a
tensor on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

from repro_torch import register_node, tree_leaves, tree_map

BLOCK = 1024


@dataclasses.dataclass
class SparseGrad:
    """Blockwise top-k compressed tensor. ``values``/``indices`` are
    torch tensors on the device, or numpy arrays once copied to host."""
    values: Any                  # (nb, k)
    indices: Any                 # (nb, k) int32, block-local
    shape: Tuple[int, ...]       # original dense shape
    block: int = BLOCK

    @property
    def nbytes(self) -> int:
        # indices fit in int16 on disk (block-local < 1024)
        return (_nbytes(self.values, _itemsize(self.values))
                + _nbytes(self.indices, 2))

    def dense(self):
        return topk_decompress(self)


register_node(SparseGrad,
              lambda s: [s.values, s.indices],
              lambda s, kids: SparseGrad(kids[0], kids[1], s.shape, s.block))


def _nbytes(a, itemsize: int) -> int:
    """Bytes of ``a`` (tensor or numpy) at ``itemsize`` per element."""
    n = int(a.numel()) if hasattr(a, "numel") else int(a.size)
    return n * itemsize


def _itemsize(a) -> int:
    return int(a.element_size()) if hasattr(a, "element_size") \
        else int(a.dtype.itemsize)


def _pad_len(n: int, block: int) -> int:
    return (block - n % block) % block


def k_for(rho: float, block: int = BLOCK) -> int:
    return max(1, int(math.ceil(rho * block)))


def topk_compress(x, rho: float, *, block: int = BLOCK) -> SparseGrad:
    """Blockwise top-|x| selection keeping k = ceil(rho * block)."""
    from repro_torch.kernels import ops
    return ops.topk_compress(x, rho, block=block)


def topk_decompress(sg: SparseGrad):
    from repro_torch.kernels import ops
    return ops.topk_decompress(sg)


def is_compressed(x) -> bool:
    """A wire container of any compressor: top-k (``SparseGrad``),
    quant8 (``QuantGrad``) or packed (``PackedDiff``)."""
    from repro_torch.compression.packed import PackedDiff
    from repro_torch.compression.quant import QuantGrad
    return isinstance(x, (SparseGrad, QuantGrad, PackedDiff))


# ------------------------- tree-level API --------------------------------

def compress_tree(grads, rho: float):
    """Per-leaf :func:`topk_compress` (K1 on the card): a tree of
    ``SparseGrad`` in the input's tree order."""
    return tree_map(lambda g: topk_compress(g, rho), grads)


def decompress_tree(cg):
    """Dense gradients of a compressed tree (each container's decode)."""
    return tree_map(lambda l: l.dense() if is_compressed(l) else l, cg,
                    is_leaf=is_compressed)


def tree_nbytes(cg) -> int:
    """Wire bytes of a compressed tree (indices at 2 B, as on disk)."""
    return sum(l.nbytes for l in tree_leaves(cg, is_leaf=is_compressed)
               if is_compressed(l))

