"""Engine configuration + factory (port of ``repro.core.engine``): every
strategy of the reference — LowDiff, LowDiff+ and the paper's baselines
(CheckFreq, Gemini, NaiveDC, FullSync) — over a store declared by a
nested :class:`~repro_torch.checkpoint.config.StoreConfig`, with the
maintenance service attached when ``maintenance`` is on.

:data:`FLAG_MAP` maps every launcher flag that configures the engine,
the store or one of its tiers to its config field;
:meth:`EngineConfig.from_args` is the one flag -> config translation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.checkpoint.config import StoreConfig
from repro_torch.core.steps import COMPRESSORS

STRATEGIES = ("none", "lowdiff", "lowdiff_plus", "checkfreq", "gemini",
              "naive_dc", "full_sync")

#: argparse dest -> (scope, field). Scopes: "engine" (EngineConfig
#: field), "store" (StoreConfig field), "tier:<kind>" (TierSpec field on
#: that tier)
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
    "maintenance": ("engine", "maintenance"),
    "gc_slice": ("engine", "gc_slice"),
    "merge_slice": ("engine", "merge_slice"),
    "scrub_interval": ("engine", "scrub_interval"),
    "trace_out": ("engine", "trace_out"),
    "metrics_out": ("engine", "metrics_out"),
    "trace_buffer": ("engine", "trace_buffer"),
    "device": ("engine", "device"),
    "ckpt_dir": ("store", "root"),
    "format": ("store", "fmt"),
    "retention": ("store", "retention_fulls"),
    "host_id": ("store", "host_id"),
    "backend": ("store", "tiers"),          # legacy name -> tier list
    "shards": ("tier:sharded", "shards"),
    "memory_capacity_mb": ("tier:memory", "capacity_mb"),
    "eviction": ("tier:memory", "eviction"),
    "remote_url": ("tier:remote", "url"),
    "chunk_mb": ("tier:remote", "chunk_mb"),
    "max_retries": ("tier:remote", "max_retries"),
    "remote_fault_rate": ("tier:remote", "fault_rate"),
    "peers": ("tier:peer", "replicas"),
    "peer_hub": ("tier:peer", "hub"),
    "peer_domain": ("tier:peer", "domain"),
    "peer_window": ("tier:peer", "window"),
    "peer_fault_rate": ("tier:peer", "fault_rate"),
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
    maintenance: bool = False     #: background GC/scrub/merge/fold service
    gc_slice: int = 64            #: keys swept per journaled GC slice
    merge_slice: int = 64         #: leaves patched per journaled fold slice
    scrub_interval: float = 0.0   #: seconds between scrubs (0 = on demand)
    trace_out: Optional[str] = None
    metrics_out: Optional[str] = None
    trace_buffer: int = 65536
    device: str = "cuda"
    store: Optional[StoreConfig] = None

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
        if self.store is not None:
            self.store.validate()

    @classmethod
    def from_args(cls, ns: Any) -> "EngineConfig":
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}

        def flag(dest: str, default: Any) -> Any:
            return getattr(ns, dest, default)

        kw = {field: flag(dest, defaults[field])
              for dest, (scope, field) in FLAG_MAP.items()
              if scope == "engine"}
        for b in ("maintenance", "replay_device"):   # on/off on the CLI
            if isinstance(kw.get(b), str):
                kw[b] = kw[b] == "on"
        root = flag("ckpt_dir", None)
        store = None
        if root:
            store = StoreConfig.from_legacy(
                root,
                backend=flag("backend", "local"),
                shards=flag("shards", 4),
                capacity_mb=flag("memory_capacity_mb", None),
                remote_url=flag("remote_url", None),
                chunk_mb=flag("chunk_mb", 4.0),
                max_retries=flag("max_retries", 4),
                remote_fault_rate=flag("remote_fault_rate", 0.0),
                fmt=flag("format", "frame"),
                retention_fulls=flag("retention", 0),
                eviction=flag("eviction", "fifo"),
                host_id=flag("host_id", None),
                peers=flag("peers", 0),
                peer_hub=flag("peer_hub", None),
                peer_domain=flag("peer_domain", "d0"),
                peer_window=flag("peer_window", 8),
                peer_fault_rate=flag("peer_fault_rate", 0.0),
                simulate_peers=True)
        cfg = cls(store=store, **kw)
        cfg.validate()
        return cfg

    def build_store(self):
        """The configured store (None when none is configured); with
        ``maintenance`` on, the background service is attached and
        started (it first resumes any task a crash left journaled)."""
        if self.store is None:
            return None
        store = self.store.build()
        if self.maintenance:
            from repro_torch.maintenance import MaintenanceService
            svc = MaintenanceService(store, gc_slice=self.gc_slice,
                                     merge_slice=self.merge_slice,
                                     scrub_interval=self.scrub_interval)
            store.attach_maintenance(svc)
            svc.start()
        return store


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
