"""Model facade: build a ported architecture from its config.

:class:`Model` is an ``nn.Module`` whose parameters are the reference's
stacked leaves under the reference's names (``embed``, ``final_norm``,
``lm_head``, ``layers.attn.wq``, …), declared on the ``meta`` device:
the module describes the tree, and the training state owns the tensors.
``init`` materializes a param tree on a device from a seeded
``torch.Generator``; ``loss_fn(params, batch)`` is the functional form
the step differentiates, ``forward(batch)`` the same function over
parameters bound into the module with ``load_params``. Serving takes
the reference's ``logits_fn``, ``init_cache``, ``decode_step``,
``cache_logical`` and, for
the encoder-decoder only, ``prefill_cache`` (None otherwise).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, lm
from repro_torch.models.param import (ParamSpec, abstractify, logical_axes,
                                      materialize, param_count)


def _declare(module: nn.Module, specs: dict, dtype) -> None:
    for name in sorted(specs):
        s = specs[name]
        if isinstance(s, ParamSpec):
            module.register_parameter(name, nn.Parameter(
                torch.empty(s.shape, dtype=dtype, device="meta")))
        else:
            sub = nn.Module()
            _declare(sub, s, dtype)
            module.add_module(name, sub)


def _tree_of(module: nn.Module) -> dict:
    out = {n: p for n, p in module.named_parameters(recurse=False)}
    out.update({n: _tree_of(m) for n, m in module.named_children()})
    return out


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        # the encoder-decoder (audio) backbone, else the decoder-only LM
        self._impl = encdec if cfg.arch_type == "audio" else lm
        self.specs = self._impl.param_specs(cfg)
        _declare(self, self.specs, cfg.pdtype())
        self.prefill_cache = (self._prefill_cache
                              if cfg.arch_type == "audio" else None)

    def abstract_params(self, shardings=None) -> dict:
        """The param tree on the ``meta`` device (see ``abstractify``)."""
        return abstractify(self.specs, self.cfg.pdtype(), shardings)

    def logical_axes(self) -> dict:
        return logical_axes(self.specs)

    def cache_logical(self):
        """Logical-axis tree matching ``init_cache``'s (for sharding)."""
        return self._impl.cache_logical(self.cfg)

    def init(self, seed: int = 0, device=None) -> dict:
        """Initialize a param tree on ``device`` (CUDA unless the CPU is
        asked for) from a ``torch.Generator`` seeded with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return materialize(gen, self.specs, self.cfg.pdtype(), dev)

    def loss_fn(self, params, batch):
        return self._impl.loss_fn(params, batch, self.cfg)

    def logits_fn(self, params, batch):
        """(B, V) f32 logits of the batch's last position."""
        return self._impl.logits_fn(params, batch, self.cfg)

    def init_cache(self, B: int, seq_len: int, device=None):
        """Zero decode caches on ``device`` (CUDA unless the CPU is
        asked for)."""
        return self._impl.init_cache(self.cfg, B, seq_len,
                                     device=resolve_device(device))

    def decode_step(self, params, cache, batch, seq_len: int):
        """(logits (B, V) f32, cache) of one token; the cache is updated
        in place."""
        return self._impl.decode_step(params, cache, batch, self.cfg,
                                      seq_len)

    def _prefill_cache(self, params, batch, B: int, seq_len: int):
        return encdec.prefill_cache(params, batch, self.cfg, B, seq_len)

    def load_params(self, params: dict) -> None:
        """Bind a param tree into the module (as its Parameters)."""
        def bind(module, tree):
            for name, v in tree.items():
                if isinstance(v, dict):
                    bind(getattr(module, name), v)
                else:
                    setattr(module, name, nn.Parameter(v, requires_grad=True))
        bind(self, params)

    def forward(self, batch):
        return self.loss_fn(_tree_of(self), batch)

    def n_params(self) -> int:
        return param_count(self.specs)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
