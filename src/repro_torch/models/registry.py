"""Model facade: build a ported architecture from its config.

:class:`Model` is an ``nn.Module`` whose parameters are the reference's
stacked leaves under the reference's names (``embed``, ``final_norm``,
``lm_head``, ``layers.attn.wq``, …), declared on the ``meta`` device:
the module describes the tree, and the training state owns the tensors.
``init`` materializes a param tree on a device from a seeded
``torch.Generator``; ``loss_fn(params, batch)`` is the functional form
the step differentiates, ``forward(batch)`` the same function over
parameters bound into the module with ``load_params``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, lm
from repro_torch.models.param import (ParamSpec, materialize, param_count)


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

    def init(self, seed: int = 0, device=None) -> dict:
        """Initialize a param tree on ``device`` (CUDA unless the CPU is
        asked for) from a ``torch.Generator`` seeded with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return materialize(gen, self.specs, self.cfg.pdtype(), dev)

    def loss_fn(self, params, batch):
        return self._impl.loss_fn(params, batch, self.cfg)

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
