"""LowDiff in PyTorch + CUDA: the port of the ``repro`` JAX package.

Same subpackage layout as ``repro`` (one port module per reference
module), same on-disk frame format and manifest records, and the Pallas
kernels of the main path rewritten as CUDA C++ for Hopper
(``kernels/csrc``). This module holds the two helpers every layer
shares: pytree walking in JAX's leaf order, and device resolution.

Leaf order matters on disk: ``jax.tree`` flattens dicts in sorted-key
order and rebuilds them sorted, and the reference's snapshot writes
that order into every frame. :func:`tree_map` / :func:`tree_leaves`
therefore sort dict keys; NamedTuples, lists and tuples keep their
order. Registered containers (``SparseGrad``) are nodes, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

__version__ = "0.1.0"

#: container types walked as nodes: {type: (children_fn, rebuild_fn)}
_NODES: dict = {}


def register_node(cls, children: Callable, rebuild: Callable) -> None:
    """Register a container whose array fields are tree children
    (``children(x) -> list``, ``rebuild(x, new_children) -> x'``)."""
    _NODES[cls] = (children, rebuild)


def _is_nt(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree, is_leaf: Callable = None) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k],
                                                              is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v, is_leaf)]
    node = _NODES.get(type(tree))
    if node is not None:
        return [l for v in node[0](tree) for l in tree_leaves(v, is_leaf)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = None):
    """``jax.tree.map``: dicts come back with sorted keys."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if _is_nt(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    node = _NODES.get(type(tree))
    if node is not None:
        kids = [tree_map(fn, v, *(node[0](r)[i] for r in rest),
                         is_leaf=is_leaf)
                for i, v in enumerate(node[0](tree))]
        return node[1](tree, kids)
    if tree is None:
        return None
    return fn(tree, *rest)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU. Raises when CUDA is asked for (the default) and there
    is none — no entry point falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
