"""Config registry: ``get_config(arch_id)`` for the ported architectures
(the dense decoder LMs of the main path) + the assigned input shapes."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeConfig, INPUT_SHAPES  # noqa: F401

# arch-id -> module name
_REGISTRY = {
    "qwen2-1.5b": "qwen2_1_5b",
    "gpt2-l": "gpt2_l",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}")
    return mod.CONFIG


def get_shape(shape_id: str) -> ShapeConfig:
    if shape_id not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {shape_id!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[shape_id]
