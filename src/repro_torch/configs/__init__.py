"""Config registry: ``get_config(arch_id)`` for every architecture of
the reference's registry, the port's own (``PORT_ONLY``) + the assigned
input shapes."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeConfig, INPUT_SHAPES  # noqa: F401

# arch-id -> module name
_REGISTRY = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "pixtral-12b": "pixtral_12b",
    "qwen2-1.5b": "qwen2_1_5b",
    "stablelm-1.6b": "stablelm_1_6b",
    "xlstm-350m": "xlstm_350m",
    "granite-3-8b": "granite_3_8b",
    "llama3-405b": "llama3_405b",
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "gpt2-l": "gpt2_l",
    "deepseek-v2-lite": "deepseek_v2_lite",
}

#: entries the reference's registry lacks (mechanisms only the port has)
PORT_ONLY = ("deepseek-v2-lite",)

ASSIGNED_ARCHS = tuple(k for k in _REGISTRY
                       if k != "gpt2-l" and k not in PORT_ONLY)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}")
    return mod.CONFIG


def get_shape(shape_id: str) -> ShapeConfig:
    if shape_id not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {shape_id!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[shape_id]
