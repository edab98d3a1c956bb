"""Deterministic synthetic training batches.

Token streams from numpy's counter-seeded PRNG, exactly as the
reference draws them (``repro.data.synthetic``): a batch depends only on
``(seed, step)``, so the two packages see byte-identical tokens and a
recovered run replays the same batches. Only the train/prefill branch of
dense decoder LMs is ported (no decode, vlm or audio inputs).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _tok_rng(seed: int, step: int):
    return np.random.default_rng(np.uint64(seed * 1_000_003 + step))


def make_batch(cfg: ArchConfig, seq_len: int, batch: int, *, step: int = 0,
               seed: int = 0, kind: str = "train",
               device="cpu") -> Dict[str, torch.Tensor]:
    """Concrete batch for training: int32 ``tokens``/``targets`` (B, S)."""
    if kind != "train" or cfg.arch_type not in ("dense",):
        raise NotImplementedError(
            f"only dense train batches are ported (kind={kind!r}, "
            f"arch_type={cfg.arch_type!r})")
    rng = _tok_rng(seed, step)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, seq_len + 1)).astype(np.int32))
    return {"tokens": toks[:, :-1].contiguous().to(device),
            "targets": toks[:, 1:].contiguous().to(device)}


class TokenStream:
    """Stateful iterator facade used by the training launcher."""

    def __init__(self, cfg: ArchConfig, seq_len: int, batch: int,
                 seed: int = 0, device="cpu"):
        self.cfg, self.seq_len, self.batch, self.seed = cfg, seq_len, batch, seed
        self.device = device
        self.step = 0

    def __next__(self):
        b = make_batch(self.cfg, self.seq_len, self.batch,
                       step=self.step, seed=self.seed, device=self.device)
        self.step += 1
        return b

    def __iter__(self):
        return self

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def restore(self, state):
        self.step = int(state["step"])
        self.seed = int(state["seed"])
