"""Declarative store configuration: a store is a typed list of tiers
(port of ``repro.checkpoint.config``).

* :class:`TierSpec` — one storage tier (``memory`` / ``local`` /
  ``sharded`` / ``remote``) with only the knobs that tier has; setting a
  knob on the wrong kind is a validation error that names the field.
* :class:`StoreConfig` — the whole store: a hot-to-cold tier list plus
  store-wide policy (format, journal compaction).

::

    cfg = StoreConfig(root="/tmp/ck", tiers=[
        TierSpec("memory", capacity_mb=256, eviction="lru"),
        TierSpec("local"),
    ])
    store = cfg.build()

``to_dict`` / ``from_dict`` round-trip losslessly and read the
reference's dicts. Settings that name work the port does not have yet
are refused with the ROADMAP item that ports it: the ``peer`` tier, a
non-zero ``retention_fulls`` (garbage collection) and a ``host_id``
(per-host journal segments), all ROADMAP §1 item 5.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

TIER_KINDS = ("peer", "memory", "local", "sharded", "remote")
#: tiers that can anchor a store (own the durable bytes + journal root)
BASE_KINDS = ("local", "sharded", "remote", "memory")
#: where the refused settings are ported
_NEXT_SLICE = "not ported yet (ROADMAP §1 item 5)"


class StoreConfigError(ValueError):
    """Invalid configuration; the message names the offending field."""


#: which TierSpec fields each kind may set (beyond "kind" itself); a
#: non-default value on any other field is rejected
_TIER_FIELDS: Dict[str, Tuple[str, ...]] = {
    "peer": ("replicas", "window", "hub", "node_id", "domain",
             "fault_rate", "max_retries", "latency_s_per_mb",
             "simulate_peers"),
    "memory": ("capacity_mb", "eviction"),
    "local": (),
    "sharded": ("shards",),
    "remote": ("url", "chunk_mb", "max_retries", "fault_rate",
               "capacity_mb", "eviction"),
}


@dataclasses.dataclass
class TierSpec:
    """One tier of the placement hierarchy. Only the fields listed in
    ``_TIER_FIELDS[kind]`` may differ from their defaults. The peer
    fields keep the reference's names so its dicts parse; the peer tier
    itself is refused."""

    kind: str
    # -- peer tier -----------------------------------------------------
    replicas: int = 2
    window: int = 8
    hub: Optional[str] = None
    node_id: Optional[str] = None
    domain: str = "d0"
    latency_s_per_mb: float = 0.0
    simulate_peers: bool = False
    # -- memory tier ---------------------------------------------------
    capacity_mb: Optional[float] = None  #: RAM budget (remote: RAM cache)
    eviction: str = "fifo"      #: victim policy over size-class buckets
    # -- sharded tier --------------------------------------------------
    shards: int = 4
    # -- remote tier ---------------------------------------------------
    url: Optional[str] = None   #: fake://bucket or file:///path
    chunk_mb: float = 4.0
    max_retries: int = 4
    fault_rate: float = 0.0     #: injected transient-fault probability

    def validate(self, where: str = "tier") -> None:
        if self.kind not in TIER_KINDS:
            raise StoreConfigError(
                f"{where}.kind: {self.kind!r} is not one of {TIER_KINDS}")
        allowed = set(_TIER_FIELDS[self.kind])
        for f in dataclasses.fields(self):
            if f.name == "kind" or f.name in allowed:
                continue
            if getattr(self, f.name) != _TIER_DEFAULTS[f.name]:
                raise StoreConfigError(
                    f"{where}.{f.name}: not a knob of kind="
                    f"{self.kind!r} (valid for {self.kind!r}: "
                    f"{sorted(allowed) or 'none'})")
        if self.kind == "peer" and self.replicas < 0:
            raise StoreConfigError(f"{where}.replicas: must be >= 0")
        if self.kind == "peer" and self.window < 1:
            raise StoreConfigError(f"{where}.window: must be >= 1")
        if self.eviction not in ("fifo", "lru"):
            raise StoreConfigError(
                f"{where}.eviction: {self.eviction!r} is not 'fifo'/'lru'")
        if self.kind == "sharded" and self.shards < 1:
            raise StoreConfigError(f"{where}.shards: must be >= 1")
        if self.capacity_mb is not None and self.capacity_mb <= 0:
            raise StoreConfigError(f"{where}.capacity_mb: must be > 0")
        if not 0.0 <= self.fault_rate <= 1.0:
            raise StoreConfigError(f"{where}.fault_rate: must be in [0,1]")
        if self.kind == "peer":
            raise StoreConfigError(
                f"{where}.kind: the peer replication tier is {_NEXT_SLICE}")

    def to_dict(self) -> Dict[str, Any]:
        """``kind`` plus the fields that differ from their defaults."""
        out: Dict[str, Any] = {"kind": self.kind}
        for f in dataclasses.fields(self):
            if f.name == "kind":
                continue
            v = getattr(self, f.name)
            if v != _TIER_DEFAULTS[f.name]:
                out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any], where: str = "tier") -> "TierSpec":
        d = dict(d)
        kind = d.pop("kind", None)
        if kind is None:
            raise StoreConfigError(f"{where}.kind: missing")
        known = {f.name for f in dataclasses.fields(cls)}
        for k in d:
            if k not in known:
                raise StoreConfigError(f"{where}.{k}: unknown field")
        spec = cls(kind=kind, **d)
        spec.validate(where)
        return spec


_TIER_DEFAULTS = {f.name: f.default for f in dataclasses.fields(TierSpec)}


def _default_tiers() -> List[TierSpec]:
    return [TierSpec("local")]


@dataclasses.dataclass
class StoreConfig:
    """The whole checkpoint store: hot-to-cold tiers + store-wide
    policy. ``build()`` is the one construction path."""

    root: Optional[str] = None
    tiers: List[TierSpec] = dataclasses.field(default_factory=_default_tiers)
    fmt: str = "frame"                 #: write serialization (reads sniff)
    retention_fulls: int = 0           #: kept full chains (0 = no GC)
    compact_every: int = 256           #: journal appends per compaction
    host_id: Optional[str] = None      #: per-host journal segments

    # ------------------------------------------------------------------
    def validate(self) -> None:
        from repro_torch.checkpoint.io import FORMATS
        if self.fmt not in FORMATS:
            raise StoreConfigError(
                f"fmt: {self.fmt!r} is not one of {FORMATS}")
        if self.retention_fulls < 0:
            raise StoreConfigError("retention_fulls: must be >= 0")
        if self.compact_every < 1:
            raise StoreConfigError("compact_every: must be >= 1")
        if not self.tiers:
            raise StoreConfigError("tiers: at least one tier is required")
        for i, t in enumerate(self.tiers):
            if not isinstance(t, TierSpec):
                raise StoreConfigError(f"tiers[{i}]: not a TierSpec")
            t.validate(f"tiers[{i}]")
        kinds = [t.kind for t in self.tiers]
        for k in kinds:
            if kinds.count(k) > 1:
                raise StoreConfigError(
                    f"tiers: duplicate kind {k!r} (one tier per kind)")
        base = kinds[-1]
        if base not in BASE_KINDS:
            raise StoreConfigError(
                f"tiers[{len(kinds) - 1}].kind: the last (coldest) tier "
                f"must be one of {BASE_KINDS}, got {base!r}")
        order = {k: i for i, k in enumerate(TIER_KINDS)}
        for i in range(len(kinds) - 1):
            if order[kinds[i]] >= order[kinds[i + 1]]:
                raise StoreConfigError(
                    f"tiers[{i + 1}].kind: tiers must run hot->cold "
                    f"({' > '.join(TIER_KINDS)}); {kinds[i + 1]!r} cannot "
                    f"sit below {kinds[i]!r}")
        needs_root = {"local", "sharded"} & set(kinds)
        if needs_root and self.root is None:
            raise StoreConfigError(
                f"root: required by tier kind(s) {sorted(needs_root)}")
        mem = next((t for t in self.tiers if t.kind == "memory"), None)
        if (mem is not None and mem.capacity_mb is not None
                and self.tiers[-1] is mem):
            raise StoreConfigError(
                "tiers: a capacity-bounded memory tier needs a lower "
                "tier to spill to (add a local/sharded/remote base)")
        if self.retention_fulls:
            raise StoreConfigError(
                f"retention_fulls: garbage collection is {_NEXT_SLICE}")
        if self.host_id is not None:
            raise StoreConfigError(
                f"host_id: the segmented journal is {_NEXT_SLICE}")

    # ------------------------------------------------------------------
    def build_backend(self):
        """Compose the backend stack cold-to-hot."""
        from repro_torch.checkpoint.backends import (LocalFSBackend,
                                                     MemoryTierBackend,
                                                     ShardedBackend)
        self.validate()
        backend = None
        for i in reversed(range(len(self.tiers))):
            spec = self.tiers[i]
            if spec.kind == "local":
                backend = LocalFSBackend(self.root, fmt=self.fmt)
            elif spec.kind == "sharded":
                backend = ShardedBackend(self.root, num_shards=spec.shards,
                                         fmt=self.fmt)
            elif spec.kind == "remote":
                backend = self._build_remote(spec, f"tiers[{i}]")
            elif spec.kind == "memory":
                cap = (int(spec.capacity_mb * 2**20)
                       if spec.capacity_mb else None)
                backend = MemoryTierBackend(backend, capacity_bytes=cap,
                                            eviction=spec.eviction)
        return backend

    def _build_remote(self, spec: TierSpec, where: str):
        from repro_torch.checkpoint.backends import MemoryTierBackend
        from repro_torch.checkpoint.remote import make_remote_backend
        url = spec.url
        if url is None:
            if self.root is None:
                raise StoreConfigError(
                    f"{where}.url: required when the store has no root "
                    f"(root becomes file://<root> by default)")
            url = f"file://{self.root}"
        lower = make_remote_backend(
            url, chunk_bytes=int(spec.chunk_mb * 2**20),
            max_retries=spec.max_retries, journal_root=self.root,
            fault_rate=spec.fault_rate, fmt=self.fmt)
        # the RAM tier over the remote store keeps object-store latency
        # off the step loop
        cap = int(spec.capacity_mb * 2**20) if spec.capacity_mb else None
        return MemoryTierBackend(lower, capacity_bytes=cap,
                                 eviction=spec.eviction)

    def build(self):
        """Backend stack + chain store + journal."""
        from repro_torch.checkpoint.store import CheckpointStore
        return CheckpointStore(self.root, backend=self.build_backend(),
                               compact_every=self.compact_every)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"root": self.root,
                "tiers": [t.to_dict() for t in self.tiers],
                "fmt": self.fmt, "retention_fulls": self.retention_fulls,
                "compact_every": self.compact_every,
                "host_id": self.host_id}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StoreConfig":
        d = dict(d)
        tiers_raw = d.pop("tiers", None)
        known = {f.name for f in dataclasses.fields(cls)}
        for k in d:
            if k not in known:
                raise StoreConfigError(f"{k}: unknown field")
        tiers = (_default_tiers() if tiers_raw is None else
                 [TierSpec.from_dict(t, f"tiers[{i}]")
                  for i, t in enumerate(tiers_raw)])
        cfg = cls(tiers=tiers, **d)
        cfg.validate()
        return cfg

    # ------------------------------------------------------------------
    @classmethod
    def from_legacy(cls, root: Optional[str], *, backend: str = "local",
                    shards: int = 4, capacity_mb: Optional[float] = None,
                    retention_fulls: int = 0, compact_every: int = 256,
                    remote_url: Optional[str] = None, chunk_mb: float = 4.0,
                    max_retries: int = 4, remote_fault_rate: float = 0.0,
                    fmt: str = "frame", eviction: str = "fifo",
                    host_id: Optional[str] = None,
                    peers: int = 0, peer_hub: Optional[str] = None,
                    peer_domain: str = "d0", peer_window: int = 8,
                    peer_fault_rate: float = 0.0,
                    simulate_peers: bool = False) -> "StoreConfig":
        """Map the legacy ``--backend`` name and keywords onto a tier
        list: the one place the legacy names are interpreted."""
        if backend == "local":
            tiers = [TierSpec("local")]
        elif backend == "sharded":
            tiers = [TierSpec("sharded", shards=shards)]
        elif backend == "memory":
            mem = TierSpec("memory", capacity_mb=capacity_mb,
                           eviction=eviction)
            tiers = [mem, TierSpec("local")] if root is not None else [mem]
        elif backend == "remote":
            tiers = [TierSpec("remote", url=remote_url, chunk_mb=chunk_mb,
                              max_retries=max_retries,
                              fault_rate=remote_fault_rate,
                              capacity_mb=capacity_mb, eviction=eviction)]
        else:
            raise StoreConfigError(
                f"backend: unknown legacy backend {backend!r}")
        if peers > 0:
            tiers.insert(0, TierSpec(
                "peer", replicas=peers, hub=peer_hub, window=peer_window,
                domain=peer_domain, fault_rate=peer_fault_rate,
                node_id=host_id, simulate_peers=simulate_peers))
        cfg = cls(root=root, tiers=tiers, fmt=fmt,
                  retention_fulls=retention_fulls,
                  compact_every=compact_every, host_id=host_id)
        cfg.validate()
        return cfg
