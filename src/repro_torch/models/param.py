"""Parameter specification & materialization.

Models declare their parameters as a nested dict of ``ParamSpec``
(shape, logical axis names, initializer), the same tree as the
reference (``repro.models.param``). ``materialize`` draws every leaf
from one explicit ``torch.Generator`` in JAX leaf order (sorted dict
keys) with the same fan-in rule. ``jax.random`` bits cannot be
reproduced in torch, so :func:`from_jax_params` carries a reference
initialization (a tree of numpy arrays) into the port instead, and
:func:`from_jax_cache` a reference decode cache.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tree_leaves, tree_map
from repro_torch.configs.base import DTYPES


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # stddev multiplier (fan-in handled here)
    dtype: Optional[str] = None   # override param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def init_std(spec: ParamSpec) -> float:
    """Standard deviation of a normal/embed leaf (fan-in rule: the
    stacked layer dim does not count towards fan-in)."""
    if spec.init == "embed":
        return spec.scale
    fan_in = spec.shape[0] if len(spec.shape) == 1 else int(np.prod(spec.shape[:-1]))
    if spec.logical and spec.logical[0] == "layers" and len(spec.shape) > 2:
        fan_in = int(np.prod(spec.shape[1:-1]))
    return spec.scale / math.sqrt(max(fan_in, 1))


def _init_leaf(gen: torch.Generator, spec: ParamSpec, dtype,
               device) -> torch.Tensor:
    dt = DTYPES[spec.dtype] if spec.dtype else dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(init_std(spec)).to(dt)    # in place: one f32 temporary


def materialize(gen: torch.Generator, specs, dtype, device) -> dict:
    """Initialize a concrete param tree from a spec tree, drawing the
    leaves from ``gen`` in sorted-key order."""
    return tree_map(lambda s: _init_leaf(gen, s, dtype, device), specs,
                    is_leaf=is_spec)


def param_count(specs) -> int:
    return sum(int(np.prod(s.shape))
               for s in tree_leaves(specs, is_leaf=is_spec))


def to_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """A leaf (tensor, numpy incl. ml_dtypes bfloat16, a read-only
    memmap view of a frame) -> tensor on ``device``. A read-only array
    bound for the card is uploaded from its own pages; one bound for
    the CPU is copied, so no tensor aliases a checkpoint file."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16)).view(np.int16))
        return t.view(torch.bfloat16).to(device=device, dtype=dtype)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cpu" and a.flags.c_contiguous:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # read-only: never written
            t = torch.from_numpy(a)
        return t.to(device=dev, dtype=dtype)
    return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)


def from_jax_params(tree, specs=None, dtype=None, device="cpu") -> dict:
    """The weight carry: a reference parameter tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's param tree on
    ``device``. With ``specs`` the tree must match it leaf for leaf."""
    if specs is not None:
        got = [tuple(np.shape(a)) for a in tree_leaves(tree)]
        want = [tuple(s.shape) for s in tree_leaves(specs, is_leaf=is_spec)]
        if got != want:
            raise ValueError(f"param tree mismatch: {got} != {want}")
    return tree_map(lambda a: to_tensor(a, device=device, dtype=dtype), tree)


def from_jax_cache(cache, device="cpu"):
    """The state carry: a reference decode cache (its NamedTuples with
    numpy leaves, e.g. ``jax.tree.map(np.asarray, cache)``; ``()`` for
    unused fields) -> the port's cache of the same types on ``device``,
    with writable leaves (decode updates them in place)."""
    from repro_torch.models import blocks, encdec, linear_attn, lm, xlstm
    types = {t.__name__: t for t in (
        lm.DecodeCache, encdec.EncDecCache, blocks.MambaCache,
        linear_attn.LinState, xlstm.MLSTMCache, xlstm.SLSTMState)}

    def carry(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return types[type(x).__name__](*(carry(v) for v in x))
        if isinstance(x, tuple) and not x:
            return ()
        return to_tensor(x, device=device)       # a copy: never aliased
    return carry(cache)
