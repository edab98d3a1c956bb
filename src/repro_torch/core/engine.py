"""Engine configuration + factory (port of ``repro.core.engine``): every
strategy of the reference — LowDiff, LowDiff+ and the paper's baselines
(CheckFreq, Gemini, NaiveDC, FullSync) — over the local backend.

:data:`FLAG_MAP` maps every launcher flag that configures the engine or
the store to its config field; :meth:`EngineConfig.from_args` is the one
flag -> config translation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.checkpoint.backends import BACKENDS, make_backend
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.steps import COMPRESSORS

STRATEGIES = ("none", "lowdiff", "lowdiff_plus", "checkfreq", "gemini",
              "naive_dc", "full_sync")

#: argparse dest -> (scope, field); scopes "engine" and "store"
FLAG_MAP: Dict[str, tuple] = {
    "strategy": ("engine", "strategy"),
    "lr": ("engine", "lr"),
    "rho": ("engine", "rho"),
    "full_interval": ("engine", "full_interval"),
    "batch_size": ("engine", "batch_size"),
    "compressor": ("engine", "compressor"),
    "persist_mode": ("engine", "persist_mode"),
    "persist_threshold": ("engine", "persist_threshold"),
    "dirty_granularity": ("engine", "dirty_granularity"),
    "diff_quant": ("engine", "diff_quant"),
    "fold_interval": ("engine", "fold_interval"),
    "fold_amplification": ("engine", "fold_amplification"),
    "replay_window": ("engine", "replay_window"),
    "replay_device": ("engine", "replay_device"),
    "snapshot_shards": ("engine", "snapshot_shards"),
    "trace_out": ("engine", "trace_out"),
    "metrics_out": ("engine", "metrics_out"),
    "trace_buffer": ("engine", "trace_buffer"),
    "device": ("engine", "device"),
    "ckpt_dir": ("store", "root"),
    "format": ("store", "fmt"),
    "backend": ("store", "backend"),
}

#: parser dests that are runtime inputs, not engine/store config
RUNTIME_FLAGS = frozenset({"arch", "reduced", "steps", "batch", "seq",
                           "seed", "log_every", "fail_at", "clean",
                           "log_level"})


class ConfigError(ValueError):
    """An engine or store setting names a value that is not valid or not
    ported."""


@dataclasses.dataclass
class EngineConfig:
    strategy: str = "lowdiff"
    lr: float = 1e-3
    rho: float = 0.01
    full_interval: int = 20     #: 0 = Eq. (10) optimum + online tuning
    batch_size: int = 2         #: 0 = Eq. (10) optimum + online tuning
    compressor: str = "topk"
    persist_mode: str = "full"
    persist_threshold: float = 0.0
    dirty_granularity: str = "leaf"
    diff_quant: str = "off"     #: quantize row-span patches (int8/int4)
    fold_interval: int = 16
    fold_amplification: float = 1.5
    replay_window: int = 0
    replay_device: bool = False   #: stage compressed payloads on device
    snapshot_shards: int = 4
    trace_out: Optional[str] = None
    metrics_out: Optional[str] = None
    trace_buffer: int = 65536
    device: str = "cuda"
    root: Optional[str] = None    #: checkpoint directory
    fmt: str = "frame"
    backend: str = "local"

    def validate(self) -> None:
        if self.strategy not in STRATEGIES:
            raise ConfigError(
                f"strategy: {self.strategy!r} is not one of {STRATEGIES}")
        if self.persist_mode not in ("full", "incremental"):
            raise ConfigError(
                f"persist_mode: {self.persist_mode!r} is not "
                f"'full'/'incremental'")
        if self.dirty_granularity not in ("leaf", "row"):
            raise ConfigError(
                f"dirty_granularity: {self.dirty_granularity!r} is not "
                f"'leaf'/'row'")
        if self.diff_quant not in ("off", "int8", "int4"):
            raise ConfigError(
                f"diff_quant: {self.diff_quant!r} is not one of "
                f"('off', 'int8', 'int4')")
        if self.compressor not in COMPRESSORS:
            raise ConfigError(
                f"compressor: {self.compressor!r} is not one of "
                f"{COMPRESSORS}")
        if self.backend not in BACKENDS:
            raise ConfigError(
                f"backend: {self.backend!r} is not one of {BACKENDS}")
        if self.fmt != "frame":
            raise ConfigError(f"fmt: {self.fmt!r} is not ported ('frame')")

    @classmethod
    def from_args(cls, ns: Any) -> "EngineConfig":
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}
        kw = {field: getattr(ns, dest, defaults[field])
              for dest, (_, field) in FLAG_MAP.items()}
        if isinstance(kw.get("replay_device"), str):
            kw["replay_device"] = kw["replay_device"] == "on"
        cfg = cls(**kw)
        cfg.validate()
        return cfg

    def build_store(self) -> Optional[CheckpointStore]:
        if self.root is None:
            return None
        return CheckpointStore(self.root, backend=make_backend(
            self.backend, self.root, fmt=self.fmt))


def make_engine(cfg: EngineConfig, model, store=None):
    """Build the configured strategy over ``store``. Returns None for
    strategy "none" — the caller runs the bare (dense) train step."""
    cfg.validate()
    if cfg.strategy == "none":
        return None
    if store is None:
        store = cfg.build_store()
    from repro_torch.core.baselines import (CheckFreq, FullSync, Gemini,
                                            NaiveDC)
    if cfg.strategy == "checkfreq":
        return CheckFreq(model, store, lr=cfg.lr, interval=10,
                         device=cfg.device)
    if cfg.strategy == "gemini":
        return Gemini(model, store, lr=cfg.lr, interval=1,
                      persist_interval=cfg.full_interval, device=cfg.device)
    if cfg.strategy == "naive_dc":
        return NaiveDC(model, store, lr=cfg.lr, rho=cfg.rho,
                       full_interval=cfg.full_interval, device=cfg.device)
    if cfg.strategy == "full_sync":
        return FullSync(model, store, lr=cfg.lr, interval=cfg.full_interval,
                        device=cfg.device)
    if cfg.strategy == "lowdiff_plus":
        from repro_torch.core.lowdiff_plus import LowDiffPlus
        return LowDiffPlus(model, store, lr=cfg.lr,
                           persist_interval=cfg.batch_size or 1,
                           persist_mode=cfg.persist_mode,
                           persist_threshold=cfg.persist_threshold,
                           dirty_granularity=cfg.dirty_granularity,
                           fold_interval=cfg.fold_interval,
                           fold_amplification=cfg.fold_amplification,
                           diff_quant=cfg.diff_quant, device=cfg.device)
    from repro_torch.core.config_opt import SystemParams
    from repro_torch.core.lowdiff import LowDiff
    return LowDiff(model, store, rho=cfg.rho, lr=cfg.lr,
                   full_interval=cfg.full_interval or None,
                   batch_size=cfg.batch_size or None,
                   compressor=cfg.compressor, sys_params=SystemParams(),
                   replay_window=cfg.replay_window or None,
                   replay_device=cfg.replay_device,
                   snapshot_shards=cfg.snapshot_shards, device=cfg.device)
