"""Checkpoint chain store: full/diff/batch semantics over a backend
(port of ``repro.checkpoint.store``; no patch chain, fold, GC,
quarantine or peer adoption yet).

Keys and manifest records are the reference's, so a chain written by
either package recovers in the other::

    full_00000010                # model state M_t
    diff_00000011                # one differential (G̃_t)
    batch_00000012_00000015      # batched differentials
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.backends import LocalFSBackend
from repro_torch.checkpoint.journal import ManifestJournal, _entry_key
from repro_torch.obs.trace import trace_span

CHAIN_KINDS = ("fulls", "diffs", "batches")

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


class CheckpointStore:
    def __init__(self, root: Optional[str] = None, *, backend=None,
                 compact_every: int = 256):
        if backend is None:
            if root is None:
                raise ValueError("CheckpointStore needs a root or a backend")
            backend = LocalFSBackend(root)
        self.backend = backend
        self.root = root if root is not None else backend.persist_root
        self._lock = threading.RLock()
        self.journal = ManifestJournal(backend.persist_root,
                                       compact_every=compact_every)
        from repro_torch.obs.metrics import InstrumentSet
        self._inst = InstrumentSet("store")
        self._bytes_written = self._inst.counter("bytes_written")
        self._writes = self._inst.counter("writes")
        self._write_time = self._inst.histogram("write_time_s")
        self._prune_missing()

    @property
    def bytes_written(self) -> int:
        return int(self._bytes_written.value)

    @property
    def writes(self) -> int:
        return int(self._writes.value)

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
        self._bytes_written.add(nbytes)
        self._writes.add(1)

    def _put(self, span: str, key: str, obj, **attrs) -> int:
        with trace_span(span, "store", key=key, **attrs) as sp:
            t0 = time.perf_counter()
            n = self.backend.put(key, obj)
            self._write_time.observe(time.perf_counter() - t0)
            sp.set(bytes=n)
        return n

    # ------------------------------------------------------------------
    def save_full(self, step: int, state) -> str:
        key = f"full_{step:08d}"
        n = self._put("store.save_full", key, state)
        self._record("fulls", {"step": step, "key": key,
                               "path": self.backend.url(key), "bytes": n}, n)
        return key

    def save_diff(self, step: int, payload) -> str:
        key = f"diff_{step:08d}"
        n = self._put("store.save_diff", key, payload)
        self._record("diffs", {"step": step, "key": key,
                               "path": self.backend.url(key), "bytes": n}, n)
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
        return key

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
    def flush(self, timeout: Optional[float] = None):
        """Block until every accepted write is durable."""
        self.backend.flush()

    def close(self):
        self.backend.close()
        self.journal.close()

    def stats(self):
        with self._lock:
            return {"writes": self.writes, "bytes": self.bytes_written,
                    "fulls": len(self.manifest["fulls"]),
                    "diffs": len(self.manifest["diffs"]),
                    "batches": len(self.manifest["batches"]),
                    "journal": self.journal.stats(),
                    "backend": self.backend.stats()}
