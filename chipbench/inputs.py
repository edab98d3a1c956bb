"""What a cell hands to both the program and the reference: the initial
weights and the token batches, drawn from the run's seed on the device.

Each leaf of the weights comes from one ``torch.Generator`` call of its
own (a dozen or so large calls: the per-layer leaves are stacked), seeded
from the run's seed and the leaf's name, so any leaf can be drawn again
alone. Batches come from one generator seeded from the run's seed: the
i-th batch of a run is the same whichever side asks for it. Tokens are
uniform over the vocabulary, so no two rows of a run are alike.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from chipbench.reference.decoder import DTYPES, param_shapes


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def leaf_weights(m: dict, seed: int, name: str, device) -> torch.Tensor:
    shape, init = param_shapes(m)[name]
    dt = DTYPES[m["param_dtype"]]
    if init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    std = 0.02 if init == "embed" else 1.0 / math.sqrt(shape[-2])
    g = torch.Generator(device=device).manual_seed(subseed(seed, "w", name))
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    return x.mul_(std).to(dt)


def weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{dotted leaf name: tensor} in the parameter dtype."""
    return {name: leaf_weights(m, seed, name, device)
            for name in param_shapes(m)}


class Batches:
    """``next(b)`` -> {"tokens", "targets"}: int32 (batch, seq), the
    targets the tokens shifted by one."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int, device):
        self.vocab, self.shape = vocab, (batch, seq + 1)
        self.gen = torch.Generator(device=device).manual_seed(
            subseed(seed, "data"))
        self.device = device

    def __iter__(self):
        return self

    def __next__(self):
        t = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                          dtype=torch.int32, device=self.device)
        return {"tokens": t[:, :-1].contiguous(),
                "targets": t[:, 1:].contiguous()}
