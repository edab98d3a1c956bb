"""Error-feedback (memory) for biased compressors [Stich et al.'18].

The residual of each compression step is added back before the next
compression. State is a dense f32 tree like the gradients. The residual
is ``corrected - decompress(cg)``, with the decompress run by the
compressor's own decode kernel (K2 for top-k, K9 for packed), so it
absorbs sparsification and quantization error alike.
"""
from __future__ import annotations

import torch

from repro_torch import tree_map
from repro_torch.compression.sparse import (is_compressed, topk_compress,
                                            topk_decompress)


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress_tree_with(grads, ef_state, compress_fn, decompress_fn):
    """Generic EF loop for any biased (compress, decompress) pair:
    compresses ``grad + residual`` per leaf and keeps the new residual.
    Returns (compressed tree, new ef state)."""
    def one(g, e):
        corrected = g.float() + e
        cg = compress_fn(corrected)
        return cg, corrected - decompress_fn(cg).float()

    pairs = tree_map(one, grads, ef_state)
    pair = lambda x: isinstance(x, tuple) and is_compressed(x[0])  # noqa: E731
    cg = tree_map(lambda t: t[0], pairs, is_leaf=pair)
    ef = tree_map(lambda t: t[1], pairs, is_leaf=pair)
    return cg, ef


def ef_compress_tree(grads, ef_state, rho: float):
    """Returns (compressed tree, new ef state) — top-k instance."""
    return ef_compress_tree_with(grads, ef_state,
                                 lambda g: topk_compress(g, rho),
                                 topk_decompress)
