"""Append-only manifest journal with periodic compaction (port of
``repro.checkpoint.journal``: the single-writer journal and the
in-memory journal of a backend with no durable root; per-host segments
are not ported).

One JSON line is appended per mutation (O(1) bytes per write) and the
log is periodically folded into an atomic snapshot — the same files and
records as the reference, so either package reads the other's chain::

    <root>/manifest.json   # snapshot {"fulls": [...], ..., "__seq__": n}
    <root>/manifest.log    # JSON lines appended after the snapshot

Recovery reads the snapshot, then replays log records with
``seq > snapshot.__seq__``; a torn tail (partial last line) is dropped.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.checkpoint import io as cio

EMPTY = {"fulls": [], "diffs": [], "batches": []}

def _read_snapshot(root: str) -> Tuple[Dict[str, List[dict]], int,
                                       Dict[str, int]]:
    """Read ``manifest.json`` into ``(manifest, legacy_seq, segment
    watermarks)``. The snapshot carries both watermark styles so a job
    can switch between the single journal and per-host segments in
    either direction without losing unfolded records."""
    manifest = _blank()
    seq = 0
    marks: Dict[str, int] = {}
    path = os.path.join(root, ManifestJournal.SNAPSHOT)
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            snap = json.load(f)
        seq = int(snap.pop("__seq__", 0))
        marks = {h: int(s) for h, s in snap.pop("__segseq__", {}).items()}
        # iterate the *snapshot's* kinds, not just the builtin three:
        # extra kinds (e.g. the scrubber's "quarantined" list) must
        # survive a compaction + reload round-trip
        for k, v in snap.items():
            manifest[k] = list(v)
    return manifest, seq, marks


def _fold_legacy_log(manifest: Dict[str, List[dict]], root: str,
                     floor: int) -> Tuple[int, int, int]:
    """Apply single-journal ``manifest.log`` records above ``floor``.
    Returns (top seq, valid bytes, total bytes)."""
    records, valid, total = read_segment(
        os.path.join(root, ManifestJournal.LOG))
    top = floor
    for rec in records:
        if rec.get("seq", 0) <= floor:
            continue  # already folded into the snapshot
        _apply(manifest, rec["op"], rec["kind"], rec.get("entry"),
               rec.get("key"))
        top = rec["seq"]
    return top, valid, total


def _blank() -> Dict[str, List[dict]]:
    return {k: [] for k in EMPTY}


class MemoryJournal:
    """Journal of a backend with no durable root (a pure RAM tier, a
    ``fake://`` bucket): the manifest lives only in this process."""

    def __init__(self):
        self.manifest = _blank()
        self.appends = 0

    def append(self, op: str, kind: str, *, entry: Optional[dict] = None,
               key: Optional[str] = None) -> int:
        _apply(self.manifest, op, kind, entry, key)
        self.appends += 1
        return 0  # no bytes hit storage

    def compact(self):
        pass

    def close(self):
        pass

    def stats(self):
        return {"appends": self.appends, "log_bytes": 0, "compactions": 0}


class ManifestJournal:
    SNAPSHOT = "manifest.json"
    LOG = "manifest.log"

    def __init__(self, root: str, compact_every: int = 256):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.compact_every = compact_every
        self.compactions = 0
        self.appends = 0
        self._seq = 0
        self._segseq: Dict[str, int] = {}
        self._since_compact = 0
        self.manifest = self._load()
        self._log = open(self._log_path(), "a", encoding="utf-8")

    # ------------------------------------------------------------------
    def _snap_path(self) -> str:
        return os.path.join(self.root, self.SNAPSHOT)

    def _log_path(self) -> str:
        return os.path.join(self.root, self.LOG)

    def _load(self) -> Dict[str, List[dict]]:
        manifest, self._seq, self._segseq = _read_snapshot(self.root)
        if any(f.startswith("manifest.") and f.endswith(".log")
               and f != self.LOG for f in os.listdir(self.root)):
            raise NotImplementedError(
                "per-host journal segments are not ported (ROADMAP §1 "
                "item 5)")
        self._seq, valid_bytes, total = _fold_legacy_log(
            manifest, self.root, self._seq)
        if valid_bytes < total:
            # drop the torn fragment so the next append starts a
            # fresh line instead of merging into it (which would
            # poison every later record on the following reload)
            with open(self._log_path(), "r+b") as f:
                f.truncate(valid_bytes)
        return manifest

    # ------------------------------------------------------------------
    def append(self, op: str, kind: str, *, entry: Optional[dict] = None,
               key: Optional[str] = None) -> int:
        """Apply a mutation and append one JSON line. Returns the number
        of journal bytes written — O(entry), independent of history."""
        _apply(self.manifest, op, kind, entry, key)
        self._seq += 1
        rec = {"seq": self._seq, "op": op, "kind": kind}
        if entry is not None:
            rec["entry"] = entry
        if key is not None:
            rec["key"] = key
        line = json.dumps(rec) + "\n"
        self._log.write(line)
        self._log.flush()
        self.appends += 1
        self._since_compact += 1
        if self._since_compact >= self.compact_every:
            self.compact()
        return len(line)

    def compact(self):
        """Fold the log into an atomic snapshot and truncate it."""
        snap = dict(self.manifest)
        snap["__seq__"] = self._seq
        if self._segseq:
            # carry the segmented-era watermarks forward so those
            # segment records are never re-applied by a later reader
            snap["__segseq__"] = self._segseq
        # shared tmp+fsync+rename+dir-fsync implementation: the rename
        # must be durable before the log is truncated, or a crash could
        # lose both the snapshot and the folded records
        cio.atomic_write(self._snap_path(),
                         lambda f: f.write(json.dumps(snap).encode("utf-8")))
        # Snapshot is durable; a crash before the truncate just replays
        # records whose seq <= __seq__, which _load skips.
        self._log.close()
        self._log = open(self._log_path(), "w", encoding="utf-8")
        self._since_compact = 0
        self.compactions += 1

    def close(self):
        if not self._log.closed:
            self._log.close()

    def log_bytes(self) -> int:
        try:
            return os.path.getsize(self._log_path())
        except OSError:
            return 0

    def stats(self):
        return {"appends": self.appends, "log_bytes": self.log_bytes(),
                "compactions": self.compactions}


def read_segment(path: str) -> Tuple[List[dict], int, int]:
    """Read a journal log file, tolerating a torn tail (partial last
    line from a crash mid-append). Returns ``(records, valid_bytes,
    total_bytes)`` — the valid record prefix and how many bytes of the
    file it spans, so callers that own the file can truncate the torn
    fragment."""
    records: List[dict] = []
    valid = 0
    try:
        total = os.path.getsize(path)
    except OSError:
        return records, 0, 0
    with open(path, "rb") as f:
        for raw in f:
            if not raw.endswith(b"\n"):
                break  # newline missing: the append was torn
            try:
                records.append(json.loads(raw.decode("utf-8")))
            except (json.JSONDecodeError, UnicodeDecodeError):
                break  # torn tail: keep the valid prefix
            valid += len(raw)
    return records, valid, total


def _entry_key(e: dict) -> Optional[str]:
    key = e.get("key")
    if key is None and "path" in e:  # pre-journal entries carried paths only
        key = os.path.basename(e["path"])
        for suffix in (".npz", ".ckpt"):
            if key.endswith(suffix):
                key = key[:-len(suffix)]
    return key


def _apply(manifest: Dict[str, List[dict]], op: str, kind: str,
           entry: Optional[dict], key: Optional[str]):
    if kind not in manifest:
        manifest[kind] = []
    if op == "add":
        manifest[kind].append(entry)
    elif op == "del":
        manifest[kind] = [e for e in manifest[kind] if _entry_key(e) != key]
    elif op == "replace":
        # atomic del-by-key + add in ONE journal record: an entry
        # rewrite (e.g. the fold advancing a full's state_step) must
        # never have a crash window in which the key exists in neither
        # form — a torn tail drops the whole record, leaving the old
        # entry intact
        manifest[kind] = ([e for e in manifest[kind]
                           if _entry_key(e) != key] + [entry])
    else:
        raise ValueError(f"unknown journal op {op!r}")
