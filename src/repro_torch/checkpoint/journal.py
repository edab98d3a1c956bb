"""Append-only manifest journals with periodic compaction (port of
``repro.checkpoint.journal``).

One JSON line is appended per mutation (O(1) bytes per write) and the
log is periodically folded into an atomic snapshot — the same files and
records as the reference, so either package reads the other's chain::

    <root>/manifest.json   # snapshot {"fulls": [...], ..., "__seq__": n}
    <root>/manifest.log    # JSON lines appended after the snapshot

Records::

    {"seq": 7, "op": "add", "kind": "fulls",  "entry": {...}}
    {"seq": 8, "op": "del", "kind": "batches", "key": "batch_..."}
    {"seq": 9, "op": "replace", "kind": "fulls", "key": "full_...",
     "entry": {...}}   # atomic del+add (entry rewrites, e.g. the fold)

Recovery reads the snapshot, then replays log records with
``seq > snapshot.__seq__``; a torn tail (partial last line) is dropped,
so recovery always sees a consistent chain prefix.

Multi-controller jobs use :class:`SegmentedManifestJournal`: each host
appends to its own segment file (``manifest.<host>.log``), and every
reader reconstructs the same merged view (records ordered by ``(seq,
host)``). The merge folds all segments into the shared snapshot, whose
``__segseq__`` map carries one watermark per host. :class:`JournalTap`
forwards every append to the peer tier.
"""
from __future__ import annotations

import json
import os
import time
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


def _fold_segments(manifest: Dict[str, List[dict]], root: str,
                   marks: Dict[str, int]
                   ) -> Tuple[Dict[str, int], Dict[str, Tuple[int, int]]]:
    """Apply every per-host segment's records above its watermark, in
    deterministic ``(seq, host)`` order. Returns (new watermarks,
    per-host byte spans)."""
    merged, marks, spans = merge_segment_records(root, marks)
    for rec in merged:
        _apply(manifest, rec["op"], rec["kind"], rec.get("entry"),
               rec.get("key"))
    return marks, spans


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
        # fold journal segments left by a segmented-era run first (they
        # predate the switch back to the single journal): a mode switch
        # must never lose records above the per-host watermarks
        self._segseq, _ = _fold_segments(manifest, self.root, self._segseq)
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


# ----------------------------------------------------------------------
# multi-controller journal segments
# ----------------------------------------------------------------------

class JournalSegment:
    """One host's append-only journal segment (``manifest.<host>.log``).

    The segment is single-writer: only its host appends, so there is no
    cross-host lock on the append path. Records carry ``(seq, host)``;
    the merged view orders them by that pair, which is deterministic no
    matter when each segment is read."""

    def __init__(self, root: str, host: str):
        if "/" in host or host.startswith("."):
            raise ValueError(f"invalid journal host id {host!r}")
        self.root = root
        self.host = host
        self.path = segment_path(root, host)
        os.makedirs(root, exist_ok=True)
        # lazily opened: a read-only recovery session must not litter
        # the root with empty segment files for its transient host id
        self._f = None

    def append_record(self, rec: dict) -> int:
        if self._f is None:
            self._f = open(self.path, "a", encoding="utf-8")
        line = json.dumps(rec) + "\n"
        self._f.write(line)
        self._f.flush()
        return len(line)

    def truncate(self):
        """Reset the segment after its records were folded into the
        snapshot. Only the owning host may call this (sole writer)."""
        if self._f is not None:
            self._f.close()
        self._f = open(self.path, "w", encoding="utf-8")

    def close(self):
        if self._f is not None and not self._f.closed:
            self._f.close()


def segment_path(root: str, host: str) -> str:
    return os.path.join(root, f"manifest.{host}.log")


def list_segment_hosts(root: str) -> List[str]:
    """Hosts with a segment file under root, sorted."""
    hosts = []
    try:
        names = os.listdir(root)
    except OSError:
        return hosts
    for f in names:
        if f.startswith("manifest.") and f.endswith(".log"):
            host = f[len("manifest."):-len(".log")]
            if host:  # skip the single-journal "manifest.log" itself
                hosts.append(host)
    return sorted(hosts)


def merge_segment_records(root: str, watermarks: Dict[str, int]
                          ) -> Tuple[List[dict], Dict[str, int],
                                     Dict[str, Tuple[int, int]]]:
    """Read every segment under root and return the deterministic merge:
    ``(records sorted by (seq, host), new per-host watermarks, per-host
    (valid_bytes, total_bytes))``. Records at or below a host's existing
    watermark are skipped (already folded into the snapshot), so the
    merge is idempotent — a crash between the snapshot write and the
    segment truncation just re-skips them on the next load."""
    merged: List[dict] = []
    marks = dict(watermarks)
    spans: Dict[str, Tuple[int, int]] = {}
    for host in list_segment_hosts(root):
        records, valid, total = read_segment(segment_path(root, host))
        spans[host] = (valid, total)
        floor = marks.get(host, 0)
        top = floor
        for rec in records:
            seq = int(rec.get("seq", 0))
            if seq <= floor:
                continue
            rec.setdefault("host", host)
            merged.append(rec)
            top = max(top, seq)
        marks[host] = top
    merged.sort(key=lambda r: (r.get("seq", 0), r.get("host", "")))
    return merged, marks, spans


class SegmentedManifestJournal:
    """Per-host manifest journal for multi-controller jobs.

    Appends go to this host's own :class:`JournalSegment` — no
    serialization on a shared writer. Loading builds the *merged* view:
    shared snapshot (``manifest.json`` with a ``__segseq__`` per-host
    watermark map) plus every segment's records above its watermark,
    applied in ``(seq, host)`` order — deterministic, so any reader
    (including single-host recovery after a multi-controller run)
    reconstructs bit-identical manifest state.

    ``compact()`` is the merge step: fold the legacy log and all
    segments into an atomic snapshot, then truncate this host's own
    segment only (sole writer — safe; another host's segment is *never*
    touched, its folded records are simply skipped by the watermark on
    every future load). Cross-host merges are serialized by a
    best-effort lock file with stale-lock breaking, so two hosts
    compacting concurrently cannot clobber each other's folds; on
    contention the merge is skipped and retried a window later. A crash
    between the snapshot write and the truncation loses nothing: folded
    records sit at or below their host's watermark.
    """

    SNAPSHOT = ManifestJournal.SNAPSHOT
    MERGE_LOCK = "manifest.merge.lock"

    def __init__(self, root: str, host: str = "h0",
                 compact_every: int = 256):
        self.root = root
        self.host = host
        os.makedirs(root, exist_ok=True)
        self.compact_every = compact_every
        self.compactions = 0
        self.merge_contentions = 0
        self.appends = 0
        self._since_compact = 0
        self._watermarks: Dict[str, int] = {}
        self._legacy_seq = 0
        #: test hook: called at named points inside compact() to inject
        #: crashes at merge boundaries (see tests/test_torch_segments.py)
        self._crash_hook = None
        self.manifest = self._load()
        self._segment = JournalSegment(root, host)
        self._seq = self._watermarks.get(host, 0)

    # ------------------------------------------------------------------
    def _snap_path(self) -> str:
        return os.path.join(self.root, self.SNAPSHOT)

    def _load(self) -> Dict[str, List[dict]]:
        manifest, legacy_floor, self._watermarks = _read_snapshot(self.root)
        # fold single-journal records left by a pre-segmented run first
        # (they predate the switch): enabling --host-id on an existing
        # store must not lose records not yet folded into the snapshot
        self._legacy_seq, _, _ = _fold_legacy_log(manifest, self.root,
                                                  legacy_floor)
        self._watermarks, spans = _fold_segments(manifest, self.root,
                                                 self._watermarks)
        # truncate only our OWN torn tail — other hosts may be mid-append
        own = spans.get(self.host)
        if own is not None and own[0] < own[1]:
            with open(segment_path(self.root, self.host), "r+b") as f:
                f.truncate(own[0])
        return manifest

    # ------------------------------------------------------------------
    def _acquire_merge_lock(self, stale_s: float = 120.0) -> bool:
        """Best-effort cross-process merge mutex: O_CREAT|O_EXCL lock
        file, broken when older than ``stale_s`` (a merger that died
        mid-merge). Returns False on live contention — the caller skips
        this merge and retries a compaction window later."""
        path = os.path.join(self.root, self.MERGE_LOCK)
        for attempt in (0, 1):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                return True
            except FileExistsError:
                try:
                    stale = time.time() - os.path.getmtime(path) > stale_s
                except OSError:
                    continue  # lock vanished under us: retry once
                if stale and attempt == 0:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    continue
                return False
        return False

    def _release_merge_lock(self) -> None:
        try:
            os.unlink(os.path.join(self.root, self.MERGE_LOCK))
        except OSError:
            pass

    # ------------------------------------------------------------------
    def append(self, op: str, kind: str, *, entry: Optional[dict] = None,
               key: Optional[str] = None) -> int:
        _apply(self.manifest, op, kind, entry, key)
        self._seq += 1
        rec = {"seq": self._seq, "host": self.host, "op": op, "kind": kind}
        if entry is not None:
            rec["entry"] = entry
        if key is not None:
            rec["key"] = key
        n = self._segment.append_record(rec)
        self.appends += 1
        self._since_compact += 1
        if self._since_compact >= self.compact_every:
            self.compact()
        return n

    def compact(self) -> bool:
        """The deterministic merge step: fold the legacy log and every
        segment into the shared snapshot, then truncate our own
        segment. Serialized across hosts by the merge lock; returns
        False when another host holds it (skip now, retry a window
        later — our records stay safely in our segment)."""
        if not self._acquire_merge_lock():
            self.merge_contentions += 1
            self._since_compact = 0
            return False
        try:
            # re-read everything from disk inside the lock: the merge
            # must fold what is durable *now*, including records other
            # hosts appended since our last load
            manifest, legacy_floor, old_marks = _read_snapshot(self.root)
            legacy_top, _, _ = _fold_legacy_log(manifest, self.root,
                                                legacy_floor)
            marks, _ = _fold_segments(manifest, self.root, old_marks)
            if self._crash_hook is not None:
                self._crash_hook("merge:premerge")
            out = dict(manifest)
            out["__seq__"] = legacy_top
            out["__segseq__"] = marks
            cio.atomic_write(
                self._snap_path(),
                lambda f: f.write(json.dumps(out).encode("utf-8")))
            if self._crash_hook is not None:
                self._crash_hook("merge:snapshotted")
            # snapshot durable: our own segment's records are folded and
            # we are its sole writer, so truncating cannot lose anything.
            # Other hosts' segments are left alone — their folded
            # records sit at or below the watermark and are skipped on
            # every future load; each host truncates its own at its own
            # next merge.
            self._segment.truncate()
            self.manifest = manifest
            self._watermarks = marks
            self._legacy_seq = legacy_top
            self._seq = max(self._seq, marks.get(self.host, 0))
            self._since_compact = 0
            self.compactions += 1
            return True
        finally:
            self._release_merge_lock()

    def close(self):
        self._segment.close()

    def log_bytes(self) -> int:
        try:
            return os.path.getsize(self._segment.path)
        except OSError:
            return 0

    def stats(self):
        return {"appends": self.appends, "log_bytes": self.log_bytes(),
                "compactions": self.compactions,
                "merge_contentions": self.merge_contentions,
                "host": self.host,
                "watermarks": dict(self._watermarks)}


class JournalTap:
    """Transparent journal wrapper that forwards every append to
    ``tap(op, kind, entry=, key=)`` *after* it is applied and durable
    locally. The chain store installs one when its backend exposes
    ``on_journal_append`` (the peer tier), so manifest records are
    replicated to peers without the journal implementations knowing.
    The tap is best-effort: a tap failure never fails the local append.
    ``append_untapped`` bypasses the tap — used when *adopting* records
    that came from peers, which must not echo back out."""

    def __init__(self, inner, tap):
        self.inner = inner
        self.tap = tap

    def append(self, op: str, kind: str, *, entry: Optional[dict] = None,
               key: Optional[str] = None) -> int:
        n = self.inner.append(op, kind, entry=entry, key=key)
        try:
            self.tap(op, kind, entry=entry, key=key)
        except Exception:  # noqa: BLE001 - replication is best-effort
            pass
        return n

    def append_untapped(self, op: str, kind: str, *,
                        entry: Optional[dict] = None,
                        key: Optional[str] = None) -> int:
        return self.inner.append(op, kind, entry=entry, key=key)

    def __getattr__(self, name):
        return getattr(self.inner, name)


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
