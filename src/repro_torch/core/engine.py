"""Engine configuration + factory (port of ``repro.core.engine``, the
subset for ``--strategy lowdiff|none`` over the local backend).

:data:`FLAG_MAP` maps every launcher flag that configures the engine or
the store to its config field; :meth:`EngineConfig.from_args` is the one
flag -> config translation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.checkpoint.backends import BACKENDS, make_backend
from repro_torch.checkpoint.store import CheckpointStore

STRATEGIES = ("none", "lowdiff")

#: argparse dest -> (scope, field); scopes "engine" and "store"
FLAG_MAP: Dict[str, tuple] = {
    "strategy": ("engine", "strategy"),
    "lr": ("engine", "lr"),
    "rho": ("engine", "rho"),
    "full_interval": ("engine", "full_interval"),
    "batch_size": ("engine", "batch_size"),
    "compressor": ("engine", "compressor"),
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
        if self.compressor != "topk":
            raise ConfigError(
                f"compressor: {self.compressor!r} is not ported ('topk')")
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
    from repro_torch.core.config_opt import SystemParams
    from repro_torch.core.lowdiff import LowDiff
    return LowDiff(model, store, rho=cfg.rho, lr=cfg.lr,
                   full_interval=cfg.full_interval or None,
                   batch_size=cfg.batch_size or None,
                   compressor=cfg.compressor, sys_params=SystemParams(),
                   replay_window=cfg.replay_window or None,
                   replay_device=cfg.replay_device,
                   snapshot_shards=cfg.snapshot_shards, device=cfg.device)
