"""Native Adam optimizer (tree-level), the port of ``repro.optim.adam``.

``AdamState`` keeps the reference's class name and fields: the frame
codec keys NamedTuples by class name, so a state written by either
package loads in the other. ``adam_update`` is the plain-torch form of
the update with the reference's arithmetic — ``1 - b1`` is rounded from
a python double, as the reference's scalar promotion rounds it. The
port's lowdiff step and its recovery apply the same update through the
fused ``topk_apply`` kernel (``kernels.replay``), whose hyper row carries
those pre-rounded complements; this function is its cross-check.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree_leaves, tree_map


class AdamState(NamedTuple):
    mu: Any       # first moment (f32 tree)
    nu: Any       # second moment (f32 tree)
    count: torch.Tensor


def adam_init(params) -> AdamState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return AdamState(zeros, tree_map(torch.clone, zeros),
                     torch.zeros((), dtype=torch.int32, device=dev))


def bias_corrections(b1: float, b2: float, count: torch.Tensor):
    """``1 - b ** count`` in f32, as the reference computes it."""
    cf = count.to(torch.float32)
    return 1.0 - b1 ** cf, 1.0 - b2 ** cf


def adam_update(params, grads, state: AdamState, *, lr=1e-3, b1=0.9,
                b2=0.999, eps=1e-8) -> Tuple[Any, AdamState]:
    count = state.count + 1
    c1, c2 = bias_corrections(b1, b2, count)

    def upd(p, g, mu, nu):
        g = g.float()
        mu2 = b1 * mu + (1 - b1) * g
        nu2 = b2 * nu + (1 - b2) * g * g
        step = lr * (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
        return (p.float() - step).to(p.dtype), mu2, nu2

    out = tree_map(lambda p, g, m, v: upd(p, g, m, v), params, grads,
                   state.mu, state.nu)
    first = lambda i: tree_map(lambda t: t[i], out,  # noqa: E731
                               is_leaf=lambda x: isinstance(x, tuple)
                               and not hasattr(x, "_fields"))
    return first(0), AdamState(first(1), first(2), count)
