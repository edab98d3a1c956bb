"""Deterministic synthetic batches (training/prefill and decode).

Token streams from numpy's counter-seeded PRNG, exactly as the
reference draws them (``repro.data.synthetic``): a batch depends only on
``(seed, step)``, so the two packages see byte-identical tokens and a
recovered run replays the same batches. The stub frontend inputs come
from the same generator after the tokens, in the reference's order: the
vlm's ``patch_embeds`` and ``loss_mask``, the audio backbone's
``src_embeds``. A decode batch is one int32 token per request and the
position ``min(seq_len - 1, 7)``, from the same generator.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec


def _tok_rng(seed: int, step: int):
    return np.random.default_rng(np.uint64(seed * 1_000_003 + step))


def _f64_to(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """An f64 array in ``dtype`` as ``jnp.asarray(x, dtype)`` gives it:
    rounded to f32 first (JAX without x64 holds no f64), then to
    ``dtype``. For bf16 that rounds twice: a value just above a bf16
    halfway point can land on it in f32 and then round to even."""
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def make_batch(cfg: ArchConfig, seq_len: int, batch: int, *, step: int = 0,
               seed: int = 0, kind: str = "train",
               device="cpu") -> Dict[str, torch.Tensor]:
    """Concrete batch for training: int32 ``tokens``/``targets`` (B, S),
    plus ``patch_embeds`` (B, P, Fd) and an f32 ``loss_mask`` (B, S)
    that masks the P patch positions (vlm), or ``src_embeds``
    (B, S_src, d) (audio), in the compute dtype. ``kind="decode"``:
    int32 ``tokens`` (B, 1) and a 0-d int32 ``pos``; any other kind is
    a train/prefill batch, as in the reference."""
    rng = _tok_rng(seed, step)
    if kind == "decode":
        toks = rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32)
        return {"tokens": torch.from_numpy(toks).to(device),
                "pos": torch.tensor(min(seq_len - 1, 7), dtype=torch.int32,
                                    device=device)}
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, seq_len + 1)).astype(np.int32))
    out = {"tokens": toks[:, :-1].contiguous(),
           "targets": toks[:, 1:].contiguous()}
    if cfg.arch_type == "vlm":
        P = min(cfg.n_patches or 16, seq_len // 2)
        out["patch_embeds"] = _f64_to(
            rng.normal(size=(batch, P, cfg.frontend_dim)), cfg.cdtype())
        mask = np.ones((batch, seq_len), np.float32)
        mask[:, :P] = 0.0
        out["loss_mask"] = torch.from_numpy(mask)
    if cfg.arch_type == "audio":
        Ss = encdec.src_len(cfg, seq_len)
        out["src_embeds"] = _f64_to(
            rng.normal(size=(batch, Ss, cfg.d_model)) * 0.1, cfg.cdtype())
    return {k: v.to(device) for k, v in out.items()}


def input_specs(cfg: ArchConfig, shape, shardings=None
                ) -> Dict[str, torch.Tensor]:
    """The inputs of a ``ShapeConfig`` as ``meta`` tensors (shapes and
    dtypes, no memory), the reference's dry-run stand-ins. ``shardings``:
    optional {name -> placement}, carried as each tensor's ``.sharding``;
    names: 'tokens', 'targets', 'loss_mask', 'patch_embeds',
    'src_embeds', 'pos'."""
    B, S = shape.global_batch, shape.seq_len

    def sds(shape_, dtype, name):
        t = torch.empty(shape_, dtype=dtype, device="meta")
        sh = (shardings or {}).get(name)
        if sh is not None:
            t.sharding = sh
        return t

    if shape.kind == "decode":
        return {"tokens": sds((B, 1), torch.int32, "tokens"),
                "pos": sds((), torch.int32, "pos")}
    out = {"tokens": sds((B, S), torch.int32, "tokens"),
           "targets": sds((B, S), torch.int32, "targets")}
    if cfg.arch_type == "vlm":
        P = min(cfg.n_patches or 16, S // 2)
        out["patch_embeds"] = sds((B, P, cfg.frontend_dim), cfg.cdtype(),
                                  "patch_embeds")
        out["loss_mask"] = sds((B, S), torch.float32, "loss_mask")
    if cfg.arch_type == "audio":
        out["src_embeds"] = sds((B, encdec.src_len(cfg, S), cfg.d_model),
                                cfg.cdtype(), "src_embeds")
    return out


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
