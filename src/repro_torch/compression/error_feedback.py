"""Error-feedback (memory) for biased compressors [Stich et al.'18].

The residual of each compression step is added back before the next
compression. State is a dense f32 tree like the gradients. The residual
is ``corrected - decompress(cg)`` with the decompress run by the
port's scatter kernel (``kernels.topk.topk_scatter``).
"""
from __future__ import annotations

import torch

from repro_torch import tree_map
from repro_torch.compression.sparse import (is_sparse, topk_compress,
                                            topk_decompress)


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress_one(g, e, rho: float):
    """(compressed, new residual) for one leaf."""
    corrected = g.float() + e
    cg = topk_compress(corrected, rho)
    residual = corrected - topk_decompress(cg).float()
    return cg, residual


def ef_compress_tree(grads, ef_state, rho: float):
    """Returns (compressed tree, new ef state) — top-k instance."""
    pairs = tree_map(lambda g, e: ef_compress_one(g, e, rho), grads,
                     ef_state)
    pair = lambda x: isinstance(x, tuple) and is_sparse(x[0])  # noqa: E731
    cg = tree_map(lambda t: t[0], pairs, is_leaf=pair)
    ef = tree_map(lambda t: t[1], pairs, is_leaf=pair)
    return cg, ef
