"""Checkpoint chain store: full/diff/batch/patch semantics over a
backend's tier stack (port of ``repro.checkpoint.store``). The manifest
journal lives under the backend's ``persist_root`` — one journal, or with
``host_id`` this host's segment of a
:class:`~repro_torch.checkpoint.journal.SegmentedManifestJournal` — or
only in this process (:class:`~repro_torch.checkpoint.journal.
MemoryJournal`) when the backend has none. A backend with a peer tier
taps every journal append (:class:`~repro_torch.checkpoint.journal.
JournalTap`), so a replacement host can adopt the manifest from the
peers (:meth:`CheckpointStore.adopt_peer_manifest`).

Keys and manifest records are the reference's, so a chain written by
either package recovers in the other::

    full_00000010                # model state M_t
    diff_00000011                # one differential (G̃_t)
    batch_00000012_00000015      # batched differentials
    patch_00000013               # incremental persist: dirty leaves/rows

The ``patches`` kind is LowDiff+'s incremental-merging persistence: each
patch blob holds what changed since the previous persist, against a
base full whose manifest entry maps each leaf path to its frame leaf
name. :meth:`CheckpointStore.load_latest_state` overlays the ordered
chain on the base; the fold (:meth:`~CheckpointStore.fold_sync`) writes
the merged chain into the base frame in place and retires it. A patch
blob is durable and journaled before any fold touches the base, so a
kill at any fold point recovers to the last committed persist.

Chain-aware garbage collection keeps ``retention_fulls`` fulls and
everything needed to replay from the oldest of them. Its mark phase
(:meth:`CheckpointStore.gc_plan`) and sweep phase
(:meth:`CheckpointStore.gc_apply`) are split so the maintenance service
(:mod:`repro_torch.maintenance`) can journal its progress and sweep in
slices; the scrubber's :meth:`CheckpointStore.quarantine` moves a corrupt
blob's entry out of its chain. No sweep touches a key whose put runs.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import io as cio
from repro_torch.checkpoint.backends import LocalFSBackend
from repro_torch.checkpoint.journal import (JournalTap, ManifestJournal,
                                            MemoryJournal,
                                            SegmentedManifestJournal,
                                            _entry_key)
from repro_torch.checkpoint.patchset import (PatchSet, RowUpdate, Span,
                                             merge_span_chain)
from repro_torch.compression.quant_span import QuantSpan
from repro_torch.obs.trace import trace_span

CHAIN_KINDS = ("fulls", "diffs", "batches", "patches")

#: source-aware durability ranking (recovery's fallback order)
DURABILITY_RANK = {"peer": 0, "memory": 1}


def entry_rank(entry: dict) -> int:
    return DURABILITY_RANK.get(entry.get("tier"), 2)


def order_fulls(fulls: List[dict]) -> List[dict]:
    """Recovery preference order over full-checkpoint entries: by the
    state the blob represents, then nominal step, then durability."""
    return sorted(fulls,
                  key=lambda e: (int(e.get("state_step", e["step"])),
                                 int(e["step"]), entry_rank(e)),
                  reverse=True)


def walk_leaves(tree, prefix: str = ""):
    """Yield ``(path, leaf)`` for every array leaf of a nested
    dict/list/tuple state, depth-first in insertion order — the
    traversal :func:`repro_torch.checkpoint.io.pack` uses. A RowUpdate or
    QuantSpan is one leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (RowUpdate, QuantSpan)):
        yield prefix[:-1], tree
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def payload_names(state) -> Dict[str, str]:
    """Map each numpy leaf's path to its frame payload name (``aN``), by
    identity: ``pack`` appends the leaf object itself for ndarrays."""
    _, arrays = cio.pack(state)
    by_id = {id(a): f"a{i}" for i, a in enumerate(arrays)}
    names = {}
    for path, leaf in walk_leaves(state):
        if isinstance(leaf, np.ndarray):
            name = by_id.get(id(leaf))
            if name is not None:
                names[path] = name
    return names


def merge_updates(state, updates) -> None:
    """Overlay a patch blob's partial state dict onto ``state`` in place:
    nested dicts merge, a RowUpdate or QuantSpan splices its row spans
    into a private copy of the base leaf (a QuantSpan is dequantized
    here, exactly once), anything else replaces."""
    for k, v in updates.items():
        if isinstance(v, dict) and isinstance(state.get(k), dict):
            merge_updates(state[k], v)
        elif isinstance(v, (RowUpdate, QuantSpan)):
            base = np.array(state[k])
            for sp in v.spans():
                base[sp.start:sp.stop] = sp.data
            state[k] = base
        else:
            state[k] = v


class CheckpointStore:
    def __init__(self, root: Optional[str] = None, *, backend=None,
                 retention_fulls: int = 0, compact_every: int = 256,
                 host_id: Optional[str] = None):
        if backend is None:
            if root is None:
                raise ValueError("CheckpointStore needs a root or a backend")
            backend = LocalFSBackend(root)
        self.backend = backend
        self.root = root if root is not None else backend.persist_root
        self.retention_fulls = retention_fulls
        self.host_id = host_id
        self._lock = threading.RLock()
        #: keys whose put runs or is not journaled yet: protected from
        #: eviction, garbage collection and the orphan sweep whatever
        #: another writer does meanwhile
        self._incoming: set = set()
        if backend.persist_root is None:
            self.journal = MemoryJournal()
        elif host_id is not None:
            self.journal = SegmentedManifestJournal(
                backend.persist_root, host=host_id,
                compact_every=compact_every)
        else:
            self.journal = ManifestJournal(backend.persist_root,
                                           compact_every=compact_every)
        # the peer tier replicates every manifest record: it taps the
        # journal's appends, the journals stay unaware of it
        tap = getattr(backend, "on_journal_append", None)
        if tap is not None:
            self.journal = JournalTap(self.journal, tap)
        #: attached MaintenanceService (repro_torch.maintenance); None
        #: runs GC and the fold synchronously
        self.maintenance = None
        self._maint_final = None
        from repro_torch.obs.metrics import InstrumentSet
        self._inst = InstrumentSet("store")
        self._bytes_written = self._inst.counter("bytes_written")
        self._writes = self._inst.counter("writes")
        self._gc_deleted = self._inst.counter("gc_deleted")
        self._quarantined = self._inst.counter("quarantined")
        self._write_time = self._inst.histogram("write_time_s")
        self._folds = self._inst.counter("folds")
        self._fold_bytes = self._inst.counter("fold_bytes")
        self._folded_patches = self._inst.counter("folded_patches")
        #: highest chain-read amplification seen (chain bytes / base
        #: frame bytes) — the adaptive fold trigger's input
        self._max_amplification = self._inst.gauge("max_amplification")
        self._prune_missing()
        self._update_protected()

    @property
    def bytes_written(self) -> int:
        return int(self._bytes_written.value)

    @property
    def writes(self) -> int:
        return int(self._writes.value)

    @property
    def gc_deleted(self) -> int:
        return int(self._gc_deleted.value)

    @property
    def folds(self) -> int:
        return int(self._folds.value)

    @property
    def fold_bytes(self) -> int:
        return int(self._fold_bytes.value)

    @property
    def folded_patches(self) -> int:
        return int(self._folded_patches.value)

    @property
    def max_amplification(self) -> float:
        return float(self._max_amplification.value)

    def instruments(self):
        return self._inst

    @property
    def manifest(self) -> Dict[str, List[dict]]:
        return self.journal.manifest

    def _record(self, kind: str, entry: dict, nbytes: int):
        entry.setdefault("format", self.backend.fmt)
        entry.setdefault("tier", self.backend.provenance)
        with self._lock:
            self.journal.append("add", kind, entry=entry)
            self._incoming.discard(entry["key"])
        self._bytes_written.add(nbytes)
        self._writes.add(1)

    def _put(self, span: str, key: str, obj, **attrs) -> int:
        # pre-protect: a capacity-bounded tier must not evict the
        # incoming blob before the journal records it, even when a
        # concurrent writer (the batch consumer, the other persist
        # worker) applies its own set in between; the caller's _record
        # ends the protection that the newest chain does not carry on
        with self._lock:
            self._incoming.add(key)
        self._update_protected()
        try:
            with trace_span(span, "store", key=key, **attrs) as sp:
                t0 = time.perf_counter()
                n = self.backend.put(key, obj)
                self._write_time.observe(time.perf_counter() - t0)
                sp.set(bytes=n)
        except BaseException:
            with self._lock:
                self._incoming.discard(key)
            raise
        return n

    # ------------------------------------------------------------------
    def save_full(self, step: int, state, *, record_names: bool = False)\
            -> str:
        """``record_names`` journals the path -> frame leaf name map that
        lets a later patch chain address this full's leaves for the
        in-place fold."""
        key = f"full_{step:08d}"
        n = self._put("store.save_full", key, state)
        entry = {"step": step, "key": key,
                 "path": self.backend.url(key), "bytes": n}
        if record_names:
            entry["names"] = payload_names(state)
        self._record("fulls", entry, n)
        self._update_protected()
        if self.retention_fulls:
            self.request_gc()
        return key

    def save_patch(self, step: int, base_key: str, updates) -> str:
        """Persist only what changed since the last persist, as a durable
        patch blob chained onto ``base_key``: ``updates`` is a partial
        state dict of whole leaves, RowUpdate or QuantSpan values. Row
        extents, the logical span bytes and the codec tags go into the
        manifest entry. The blob lands and is journaled before any fold
        touches the base frame: it is the fold's write-ahead log."""
        if self.backend.fmt == "npz":
            raise ValueError(
                "incremental persistence (save_patch) requires the "
                "frame checkpoint format; this store writes npz — use "
                "--format frame or --persist-mode full")
        key = f"patch_{step:08d}"
        n = self._put("store.save_patch", key,
                      {"base": base_key, "step": step, "updates": updates})
        entry = {"step": step, "key": key, "base": base_key,
                 "path": self.backend.url(key), "bytes": n}
        extents = {}
        span_bytes = 0
        codecs = set()
        for path, leaf in walk_leaves(updates):
            if isinstance(leaf, (RowUpdate, QuantSpan)):
                extents[path] = leaf.extents()
                if isinstance(leaf, QuantSpan):
                    codecs.add(f"int{leaf.bits}")
                    span_bytes += leaf.logical_nbytes
                else:
                    span_bytes += leaf.nbytes
        if extents:
            entry["extents"] = extents
            entry["span_bytes"] = int(span_bytes)
        if codecs:
            entry["codec"] = sorted(codecs)
        self._record("patches", entry, n)
        self._update_protected()
        with self._lock:
            self._max_amplification.set(
                max(self.max_amplification, self.chain_amplification()))
        return key

    def chain_amplification(self, base_key: Optional[str] = None) -> float:
        """Stored chain bytes recovery reads on top of the base frame,
        divided by the base frame's bytes (post-codec: a quantized chain
        amplifies 4-8x less than its logical size). Defaults to the
        newest addressable full; 0.0 without a chain. Lock-only."""
        with self._lock:
            if base_key is None:
                fulls = [e for e in self.manifest["fulls"] if "names" in e]
                if not fulls:
                    return 0.0
                entry = max(fulls, key=lambda e: int(e["step"]))
                base_key = self._entry_key(entry)
            else:
                entry = next((e for e in self.manifest["fulls"]
                              if self._entry_key(e) == base_key), None)
                if entry is None:
                    return 0.0
            base_bytes = max(int(entry.get("bytes", 0)), 1)
            chain = sum(int(e.get("bytes", 0))
                        for e in self.manifest.get("patches", [])
                        if e.get("base") == base_key)
        return chain / base_bytes

    def save_diff(self, step: int, payload) -> str:
        key = f"diff_{step:08d}"
        n = self._put("store.save_diff", key, payload)
        self._record("diffs", {"step": step, "key": key,
                               "path": self.backend.url(key), "bytes": n}, n)
        self._update_protected()
        return key

    def save_batch(self, first: int, last: int, payloads: list,
                   mode: str = "concat") -> str:
        """One I/O operation carrying differentials [first..last]."""
        if mode != "concat":
            raise NotImplementedError(f"batch mode {mode!r} is not ported")
        key = f"batch_{first:08d}_{last:08d}"
        n = self._put("store.save_batch", key,
                      {"mode": mode, "first": first, "last": last,
                       "payloads": payloads}, n=len(payloads))
        self._record("batches", {"first": first, "last": last, "key": key,
                                 "path": self.backend.url(key),
                                 "bytes": n}, n)
        self._update_protected()
        return key

    # ------------------------------------------------------------------
    def _update_protected(self):
        """Tell the backend which blobs form the newest full's chain (the
        full plus every diff/batch/patch after its step), plus the keys
        whose put runs or is not journaled yet; computed and applied
        under the store lock so concurrent writers cannot apply stale
        sets. The local tier evicts nothing; a capacity-bounded tier
        keeps these."""
        with self._lock:
            keys = set(self._incoming)
            fulls = self.manifest["fulls"]
            if not fulls and not keys:
                return
            if fulls:
                newest = max(fulls, key=lambda e: e["step"])
                cutoff = newest["step"]
                keys.add(self._entry_key(newest))
                keys.update(self._entry_key(e)
                            for e in self.manifest["diffs"]
                            if e["step"] > cutoff)
                keys.update(self._entry_key(e)
                            for e in self.manifest["batches"]
                            if e["last"] > cutoff)
                keys.update(self._entry_key(e)
                            for e in self.manifest.get("patches", [])
                            if e["step"] > cutoff)
            self.backend.protect(keys)

    # ------------------------------------------------------------------
    @staticmethod
    def _entry_key(entry: dict) -> str:
        return _entry_key(entry)

    def _prune_missing(self):
        """Drop manifest entries whose blob never became durable."""
        with self._lock:
            for kind in CHAIN_KINDS:
                for e in list(self.manifest.get(kind, [])):
                    key = self._entry_key(e)
                    if not self.backend.exists(key):
                        self.journal.append("del", kind, key=key)

    def latest_full(self) -> Optional[dict]:
        with self._lock:
            fulls = sorted(self.manifest["fulls"], key=lambda e: e["step"])
        return fulls[-1] if fulls else None

    def load_full(self, entry: dict):
        return self.backend.get(self._entry_key(entry))

    def diffs_after(self, step: int) -> List[Tuple[int, Any]]:
        """Ordered (step, payload) list of differentials with step >
        ``step``; a step present both standalone and in a batch comes
        from the standalone blob, and covered batches are not read."""
        with self._lock:
            diffs = list(self.manifest["diffs"])
            batches = list(self.manifest["batches"])
        chosen: Dict[int, dict] = {}
        for e in diffs:
            if e["step"] > step:
                chosen[e["step"]] = e
        out = {s: self.backend.get(self._entry_key(e))
               for s, e in chosen.items()}
        for e in batches:
            if e["last"] <= step:
                continue
            lo = max(step, e["first"] - 1)
            if all(s in out for s in range(lo + 1, e["last"] + 1)):
                continue
            blob = self.backend.get(self._entry_key(e))
            for i, pay in enumerate(blob["payloads"]):
                s = blob["first"] + i
                if s > step and s not in out:
                    out[s] = pay
        return sorted(out.items())

    # ------------------------------------------------------------------
    # incremental-merging persistence: patch chains + fold
    # ------------------------------------------------------------------
    def patch_chain(self, base_key: str) -> List[dict]:
        """Ordered patch entries chained onto ``base_key``."""
        with self._lock:
            return sorted((e for e in self.manifest.get("patches", [])
                           if e.get("base") == base_key),
                          key=lambda e: e["step"])

    def load_latest_state(self, *, merge=merge_updates, finish=None):
        """Newest persisted state: the latest loadable full overlaid with
        its ordered patch chain. Returns ``(state, step)``, ``step`` the
        last committed persist the state represents. Unreadable fulls
        fall back to older ones; an unreadable patch cuts the chain at
        the gap. Raises FileNotFoundError when no full is loadable.
        ``merge(state, updates)`` overlays one patch blob and
        ``finish(state)`` runs once the chain is overlaid (the device
        overlay of ``recovery.load_state_device`` plugs in here)."""
        from repro_torch.checkpoint.io import FrameCorruptionError
        from repro_torch.checkpoint.remote import RetryExhaustedError
        unreadable = (FileNotFoundError, RetryExhaustedError,
                      FrameCorruptionError)
        with self._lock:
            fulls = order_fulls(self.manifest["fulls"])
        if not fulls:
            raise FileNotFoundError("no persisted checkpoint")
        last_err = None
        for entry in fulls:
            try:
                state = self.load_full(entry)
            except unreadable as e:
                last_err = e
                continue
            step = int(entry.get("state_step", entry["step"]))
            for pe in self.patch_chain(self._entry_key(entry)):
                try:
                    blob = self.backend.get(self._entry_key(pe))
                except unreadable:
                    break            # cut at the gap: prefix is committed
                merge(state, blob["updates"])
                step = max(step, int(pe["step"]))
            if finish is not None:
                finish(state)
            return state, step
        raise FileNotFoundError(
            f"none of {len(fulls)} full checkpoints is loadable "
            f"(last error: {last_err})")

    # ------------------------------------------------------------------
    # peer-manifest adoption (replacement-host recovery)
    # ------------------------------------------------------------------
    def adopt_peer_manifest(self, src: Optional[str] = None) -> int:
        """Rebuild a dead host's manifest from the records its peers hold
        (the peer tier replicates every journal append). With no local
        full, the peers' records replay verbatim (add / del / replace in
        order); with local fulls, only ``add`` records of unknown keys
        are adopted, so peers never regress durable state. Adopted
        entries are tagged ``tier="peer"`` (:func:`order_fulls` ranks
        them below a durable full of the same state), bypass the tap (no
        echo back to the peers), and entries reachable nowhere are
        pruned. Returns the records applied; 0 without a peer tier."""
        fetch = getattr(self.backend, "peer_manifest", None)
        if fetch is None:
            return 0
        records = fetch(src)
        applied = 0
        with self._lock:
            append = getattr(self.journal, "append_untapped",
                             self.journal.append)
            have_fulls = bool(self.manifest.get("fulls"))
            known = {(kind, self._entry_key(e))
                     for kind, entries in self.manifest.items()
                     for e in entries if isinstance(e, dict)}
            for _, _, rec in records:
                op, kind = rec.get("op"), rec.get("kind")
                entry, key = rec.get("entry"), rec.get("key")
                if op == "add" and entry is not None:
                    k = (kind, self._entry_key(entry))
                    if k in known:
                        continue
                    e = dict(entry)
                    e["tier"] = "peer"
                    append("add", kind, entry=e)
                    known.add(k)
                    applied += 1
                elif have_fulls:
                    continue   # never let peers mutate durable state
                elif op == "del" and key is not None:
                    append("del", kind, key=key)
                    known.discard((kind, key))
                    applied += 1
                elif op == "replace" and entry is not None:
                    e = dict(entry)
                    e["tier"] = "peer"
                    append("replace", kind, key=key, entry=e)
                    known.add((kind, self._entry_key(e)))
                    applied += 1
        self._prune_missing()
        self._update_protected()
        return applied

    def fold_plan(self):
        """Mark phase: ``(base_key, [patch keys in step order],
        state_step)`` for the newest foldable chain (an older full's
        chain too: a restart must not orphan it), or None. Lock-only."""
        with self._lock:
            fulls = sorted(self.manifest["fulls"],
                           key=lambda e: e["step"], reverse=True)
            for entry in fulls:
                if "names" not in entry:
                    continue   # no leaf-name map: frame not addressable
                base_key = self._entry_key(entry)
                patches = sorted(
                    (e for e in self.manifest.get("patches", [])
                     if e.get("base") == base_key),
                    key=lambda e: e["step"])
                if patches:
                    return (base_key,
                            [self._entry_key(e) for e in patches],
                            int(patches[-1]["step"]))
        return None

    def fold_updates(self, base_key: str,
                     patch_keys: List[str]) -> Optional[PatchSet]:
        """Load the planned chain and merge it newest-wins into a
        PatchSet of raw rows (a QuantSpan is dequantized here, so a
        folded base never holds quantized bytes). None when the chain or
        its base is gone."""
        with self._lock:
            entry = next((e for e in self.manifest["fulls"]
                          if self._entry_key(e) == base_key), None)
            names = dict(entry["names"]) if entry and "names" in entry \
                else None
        if names is None:
            return None
        chains: Dict[str, List[List[Span]]] = {}
        shapes: Dict[str, tuple] = {}
        for key in patch_keys:
            try:
                blob = self.backend.get(key)
            except FileNotFoundError:
                return None
            for path, leaf in walk_leaves(blob["updates"]):
                if isinstance(leaf, (RowUpdate, QuantSpan)):
                    spans = leaf.spans()
                    shapes[path] = tuple(int(x) for x in leaf.shape)
                else:
                    a = np.asarray(leaf)
                    spans = [Span(0, a)]
                    shapes[path] = a.shape
                chains.setdefault(path, []).append(spans)
        out = PatchSet()
        for path, chain in chains.items():
            name = names.get(path)
            if name is None:
                raise KeyError(
                    f"patch leaf {path!r} is not addressable in base "
                    f"{base_key!r} (missing from its name map)")
            out.add_spans(name, merge_span_chain(chain), shapes[path])
        return out

    def fold_slice(self, base_key: str, updates) -> int:
        """Sweep phase, one slice: write these leaves into the base frame
        in place (blob I/O, never under the manifest lock)."""
        with trace_span("store.fold_slice", "maintenance",
                        key=base_key) as sp:
            n = self.backend.patch(base_key, updates)
            sp.set(bytes=n)
        self._fold_bytes.add(n)
        return n

    def fold_commit(self, base_key: str, patch_keys: List[str],
                    state_step: int) -> None:
        """Retire a folded chain: advance the base entry's
        ``state_step`` first (one atomic ``replace`` record), then delete
        the patch records and blobs. A crash between deletions leaves a
        suffix of the chain, which replays over the folded base to the
        same bytes."""
        with self._lock:
            entry = next((e for e in self.manifest["fulls"]
                          if self._entry_key(e) == base_key), None)
            if entry is not None and \
                    int(entry.get("state_step", entry["step"])) < state_step:
                e2 = dict(entry)
                e2["state_step"] = int(state_step)
                self.journal.append("replace", "fulls", entry=e2,
                                    key=base_key)
        for key in patch_keys:
            with self._lock:
                self.journal.append("del", "patches", key=key)
            self.backend.delete(key)
        self._folds.add(1)
        self._folded_patches.add(len(patch_keys))
        self._update_protected()

    def fold_sync(self, merge_slice: Optional[int] = None) -> int:
        """Synchronous fold: mark, sweep in ``merge_slice``-leaf slices,
        commit. Returns the number of patches folded."""
        plan = self.fold_plan()
        if plan is None:
            return 0
        base_key, patch_keys, state_step = plan
        updates = self.fold_updates(base_key, patch_keys)
        if updates is None:
            return 0
        names = updates.names()
        width = max(1, int(merge_slice)) if merge_slice else len(names) or 1
        for i in range(0, len(names), width):
            self.fold_slice(base_key, updates.subset(names[i:i + width]))
        self.fold_commit(base_key, patch_keys, state_step)
        return len(patch_keys)

    def request_fold(self) -> None:
        """Fold the chain off the persist thread: on the attached
        maintenance service (journaled, sliced, non-blocking) when one
        runs, else synchronously."""
        svc = self.maintenance
        if svc is not None and svc.running:
            svc.request_fold()
            return
        self.fold_sync()

    # ------------------------------------------------------------------
    # garbage collection: mark (plan) / sweep (apply)
    # ------------------------------------------------------------------
    def _keep(self, retention_fulls: Optional[int]) -> int:
        return (self.retention_fulls if retention_fulls is None
                else retention_fulls)

    def gc_plan(self, retention_fulls: Optional[int] = None
                ) -> List[Tuple[str, str]]:
        """Mark phase, no I/O: the ``[(kind, key), ...]`` superseded by a
        newer full. Keeps the newest ``retention_fulls`` fulls and every
        differential, batch or patch that a chain from the oldest kept
        full could replay (a batch straddling the cutoff is kept whole;
        a patch goes with its base)."""
        keep = self._keep(retention_fulls)
        if keep < 1:
            return []
        doomed: List[Tuple[str, str]] = []
        with trace_span("store.gc_plan", "maintenance") as sp, self._lock:
            fulls = sorted(self.manifest["fulls"], key=lambda e: e["step"])
            if len(fulls) <= keep:
                return doomed
            cutoff = fulls[-keep]["step"]
            doomed_fulls = set()
            for e in fulls[:-keep]:
                doomed_fulls.add(self._entry_key(e))
                doomed.append(("fulls", self._entry_key(e)))
            for e in self.manifest["diffs"]:
                if e["step"] <= cutoff:
                    doomed.append(("diffs", self._entry_key(e)))
            for e in self.manifest["batches"]:
                if e["last"] <= cutoff:
                    doomed.append(("batches", self._entry_key(e)))
            for e in self.manifest.get("patches", []):
                if e["step"] <= cutoff or e.get("base") in doomed_fulls:
                    doomed.append(("patches", self._entry_key(e)))
            sp.set(n=len(doomed))
        return doomed

    def _live_chain_keys(self, keep: int) -> set:
        """Keys the newest ``keep`` chains still need: the kept fulls and
        every diff/batch/patch replayable after the oldest of them."""
        keys = set()
        with self._lock:
            fulls = sorted(self.manifest["fulls"], key=lambda e: e["step"])
            retained = fulls[-max(keep, 1):]
            if not retained:
                return keys
            cutoff = retained[0]["step"]
            retained_keys = {self._entry_key(e) for e in retained}
            keys.update(retained_keys)
            keys.update(self._entry_key(e) for e in self.manifest["diffs"]
                        if e["step"] > cutoff)
            keys.update(self._entry_key(e) for e in self.manifest["batches"]
                        if e["last"] > cutoff)
            keys.update(self._entry_key(e)
                        for e in self.manifest.get("patches", [])
                        if e["step"] > cutoff
                        and e.get("base") in retained_keys)
        return keys

    def gc_apply(self, doomed: List[Tuple[str, str]],
                 retention_fulls: Optional[int] = None,
                 crash_hook=None) -> Dict[str, int]:
        """Sweep phase: journal the deletion, then delete the blob, per
        marked ``(kind, key)``; idempotent, so a resumed slice re-runs
        harmlessly. A key back in the newest kept chains since the plan
        (a same-step re-put), or whose put runs now, is skipped. Blob
        I/O runs outside the store lock. ``crash_hook(point, key)`` fires
        between the journal record and the blob delete."""
        live = self._live_chain_keys(self._keep(retention_fulls))
        removed = {"fulls": 0, "diffs": 0, "batches": 0}
        with trace_span("store.gc_apply", "maintenance", n=len(doomed)):
            for kind, key in doomed:
                if key in live:
                    continue
                with self._lock:
                    if key in self._incoming:
                        continue
                    self.journal.append("del", kind, key=key)
                if crash_hook is not None:
                    crash_hook("gc:mid_delete", key)
                self.backend.delete(key)
                removed[kind] = removed.get(kind, 0) + 1
                self._gc_deleted.add(1)
        self._update_protected()
        return removed

    def gc(self, retention_fulls: Optional[int] = None) -> Dict[str, int]:
        """Synchronous mark + sweep. Returns per-kind delete counts."""
        doomed = self.gc_plan(retention_fulls)
        if not doomed:
            return ({} if self._keep(retention_fulls) < 1 else
                    {"fulls": 0, "diffs": 0, "batches": 0})
        return self.gc_apply(doomed, retention_fulls)

    def request_gc(self, retention_fulls: Optional[int] = None):
        """GC on the attached maintenance service (non-blocking) when one
        runs, else a synchronous sweep."""
        svc = self.maintenance
        if svc is not None and svc.running:
            svc.request_gc(retention_fulls)
            return None
        return self.gc(retention_fulls)

    def scrub_targets(self) -> List[Tuple[str, str]]:
        """Every chain entry as ``(kind, key)``, a snapshot under the
        lock: what the scrubber walks and the peer prune keeps."""
        with self._lock:
            return [(kind, self._entry_key(e))
                    for kind in CHAIN_KINDS
                    for e in self.manifest.get(kind, [])]

    def merge_journal(self):
        """Fold the journal into its snapshot under the store lock (a
        segmented journal merges every host's segment)."""
        with self._lock:
            self.journal.compact()

    def sweep_orphans(self, min_age_s: float = 60.0) -> int:
        """The backend's orphan sweep, sparing every key whose put runs
        or is not journaled yet: a put can outlast any age gate (a
        17 GB full through a remote tier takes about a minute)."""
        with self._lock:
            spare = set(self._incoming)
        return self.backend.sweep_orphans(min_age_s, spare)

    # ------------------------------------------------------------------
    # quarantine (integrity scrubber)
    # ------------------------------------------------------------------
    def quarantine(self, kind: str, key: str, reason: str) -> bool:
        """Move a corrupt blob's entry from its chain kind to the
        ``quarantined`` list: recovery skips it (falls back to an older
        full, or cuts the chain at the gap) instead of meeting the
        corruption at restore time. The blob stays for forensics until
        :meth:`drop_quarantined`."""
        with self._lock:
            entry = next((e for e in self.manifest.get(kind, [])
                          if self._entry_key(e) == key), None)
            if entry is None:
                return False
            self.journal.append("del", kind, key=key)
            q = dict(entry)
            q.update({"key": key, "src_kind": kind, "reason": reason})
            self.journal.append("add", "quarantined", entry=q)
        self._quarantined.add(1)
        self._update_protected()
        return True

    def drop_quarantined(self) -> int:
        """Delete quarantined blobs and their records. Returns count."""
        with self._lock:
            entries = list(self.manifest.get("quarantined", []))
        n = 0
        for e in entries:
            key = self._entry_key(e)
            with self._lock:
                self.journal.append("del", "quarantined", key=key)
            self.backend.delete(key)
            n += 1
        return n

    # ------------------------------------------------------------------
    def flush(self, timeout: Optional[float] = None):
        """Block until every accepted write is durable at the lowest tier
        (a failed asynchronous write-back is re-raised here) and every
        requested maintenance task has finished, within ``timeout``: a
        task failure re-raises as ``CheckpointingError``."""
        self.backend.flush()
        if self.maintenance is not None:
            self.maintenance.drain(timeout)

    def attach_maintenance(self, service):
        """Attach (or detach with None) a MaintenanceService: retention
        GC and the fold then run on it, ``flush`` drains it and
        ``close`` stops it."""
        self.maintenance = service

    def close(self):
        svc, self.maintenance = self.maintenance, None
        if svc is not None:
            svc.stop()
            # stats() keeps the service's final numbers after close
            self._maint_final = svc.stats()
        self.backend.close()
        self.journal.close()

    def stats(self):
        with self._lock:
            return {"writes": self.writes, "bytes": self.bytes_written,
                    "fulls": len(self.manifest["fulls"]),
                    "diffs": len(self.manifest["diffs"]),
                    "batches": len(self.manifest["batches"]),
                    "patches": len(self.manifest.get("patches", [])),
                    "folds": self.folds, "fold_bytes": self.fold_bytes,
                    "folded_patches": self.folded_patches,
                    "chain_amplification": self.chain_amplification(),
                    "max_amplification": self.max_amplification,
                    "gc_deleted": self.gc_deleted,
                    "quarantined": len(self.manifest.get("quarantined", [])),
                    "journal": self.journal.stats(),
                    "backend": self.backend.stats(),
                    "maintenance": (self.maintenance.stats()
                                    if self.maintenance is not None
                                    else self._maint_final)}
