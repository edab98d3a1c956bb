"""Checkpoint storage backends (port of ``repro.checkpoint.backends``;
the mesh-following shard splitter is not ported; the peer tier is in
:mod:`repro_torch.checkpoint.peer`).

A backend is a key -> tree blob store; :class:`repro_torch.checkpoint.
store.CheckpointStore` layers the full/diff/batch chain semantics and
the manifest journal on top. Three implementations here, and the remote
object-store tier in :mod:`repro_torch.checkpoint.remote`:

* :class:`LocalFSBackend` — one atomic file per key on a local
  directory: a streamed ``.ckpt`` frame (default) or legacy ``.npz``.
* :class:`MemoryTierBackend` — a CPU-RAM tier: writes land in host
  memory and are written back asynchronously to an optional lower
  backend; reads hit RAM first. A byte capacity bounds the tier; blobs
  outside the newest full's chain are evicted once written back.
* :class:`ShardedBackend` — splits leaves across shard directories
  (along the largest dimension) and writes/reads the shards
  concurrently; ``get`` re-assembles every leaf bit-exactly.

Layouts on disk are the reference's, so each package reads what the
other wrote.
"""
from __future__ import annotations

import abc
import json
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import io as cio
from repro_torch.checkpoint.patchset import PatchSet
from repro_torch.obs.trace import trace_span


def split_sizes(extent: int, parts: int) -> List[int]:
    """Piece sizes ``np.array_split(a, parts)`` produces along an axis of
    ``extent``: the boundary math a range patch needs per shard."""
    base, rem = divmod(int(extent), int(parts))
    return [base + 1 if i < rem else base for i in range(parts)]


def _patchset(patch) -> PatchSet:
    if not isinstance(patch, PatchSet):
        raise TypeError(f"patch takes a PatchSet, not "
                        f"{type(patch).__name__}")
    return patch


class StorageBackend(abc.ABC):
    """Key -> checkpoint blob store. Keys are flat path-safe strings."""

    name = "abstract"
    #: directory where the manifest journal lives; None for purely
    #: in-memory backends
    persist_root: Optional[str] = None
    #: format new blobs are written in ("frame" or "npz"); reads sniff
    fmt: str = "frame"

    @property
    def provenance(self) -> str:
        """Durability class recorded per manifest entry (``tier``):
        wrapping tiers report their own name ("memory": RAM-durable until
        the write-back lands)."""
        return self.name

    @abc.abstractmethod
    def put(self, key: str, obj: Any) -> int:
        """Store obj. Returns bytes written."""

    @abc.abstractmethod
    def get(self, key: str) -> Any:
        """Load and return the blob. Raises FileNotFoundError if absent."""

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        """Remove the blob (idempotent)."""

    @abc.abstractmethod
    def exists(self, key: str) -> bool: ...

    @abc.abstractmethod
    def keys(self) -> List[str]: ...

    def url(self, key: str) -> str:
        return f"{self.name}://{key}"

    def patch(self, key: str, patch: PatchSet) -> int:
        """Rewrite the row spans of a :class:`PatchSet` into the frame
        blob ``key`` in place (the fold of a patch chain into its base).
        Returns bytes written. npz blobs raise ``ValueError``."""
        raise NotImplementedError(
            f"{self.name} backend cannot patch blobs in place")

    def protect(self, keys) -> None:
        """``keys`` form the newest full's replay chain: a capacity-bounded
        tier must never evict them. Durable tiers evict nothing."""

    def verify(self, key: str) -> Optional[str]:
        """None when the blob is intact, else the corruption reason.
        Raises FileNotFoundError when it is absent; infrastructure errors
        (a remote tier's exhausted retries) propagate."""
        try:
            self.get(key)
        except FileNotFoundError:
            raise
        except Exception as e:  # decode/checksum/struct failures
            return f"{type(e).__name__}: {e}"
        return None

    def sweep_orphans(self, min_age_s: float = 60.0, spare=()) -> int:
        """Remove debris no committed blob references (crashed
        half-writes) older than ``min_age_s``, never that of a key in
        ``spare`` (the store's puts in flight). Returns the count."""
        return 0

    def flush(self) -> None:
        """Block until every accepted put is durable at the lowest tier."""

    def close(self) -> None:
        self.flush()

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.name}


# ----------------------------------------------------------------------
# Local filesystem
# ----------------------------------------------------------------------

class LocalFSBackend(StorageBackend):
    """One atomic file per key: ``<key>.ckpt`` streamed frames (reads are
    lazy ``np.memmap`` views) or ``<key>.npz`` (``fmt="npz"``). Reads
    sniff the magic, so a mixed-format chain keeps recovering."""

    name = "local"
    SUFFIXES = {"frame": ".ckpt", "npz": ".npz"}

    def __init__(self, root: str, *, fmt: str = "frame",
                 mmap_reads: bool = True):
        if fmt not in self.SUFFIXES:
            raise ValueError(f"fmt must be one of {tuple(self.SUFFIXES)}")
        self.root = root
        self.persist_root = root
        self.fmt = fmt
        self.mmap_reads = mmap_reads
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str, fmt: Optional[str] = None) -> str:
        return os.path.join(self.root,
                            f"{key}{self.SUFFIXES[fmt or self.fmt]}")

    def _find(self, key: str) -> Optional[str]:
        # the configured format first: it is the authoritative copy
        for fmt in sorted(self.SUFFIXES, key=lambda f: f != self.fmt):
            p = self._path(key, fmt)
            if os.path.exists(p):
                return p
        return None

    def put(self, key: str, obj: Any) -> int:
        with trace_span("backend.put", "backend", tier=self.name,
                        key=key) as sp:
            if self.fmt == "frame":
                n = cio.save_frame(self._path(key), obj)
            else:
                n = cio.save(self._path(key), obj)
            sp.set(bytes=n)
        # a stale file of the other format would shadow the fresh write
        for fmt in self.SUFFIXES:
            if fmt != self.fmt:
                try:
                    os.unlink(self._path(key, fmt))
                except FileNotFoundError:
                    pass
        return n

    def get(self, key: str) -> Any:
        path = self._find(key)
        if path is None:
            raise FileNotFoundError(f"no blob {key!r} in {self.root}")
        return cio.load_any(path, mmap=self.mmap_reads)

    def patch(self, key: str, patch: PatchSet) -> int:
        path = self._find(key)
        if path is None:
            raise FileNotFoundError(f"no blob {key!r} in {self.root}")
        if not cio.is_frame_file(path):
            raise ValueError(
                f"cannot patch npz blob {key!r} in place; incremental "
                f"persistence requires the frame format")
        return cio.patch_frame(path, _patchset(patch))

    def delete(self, key: str) -> None:
        for fmt in self.SUFFIXES:
            try:
                os.unlink(self._path(key, fmt))
            except FileNotFoundError:
                pass

    def exists(self, key: str) -> bool:
        return self._find(key) is not None

    def verify(self, key: str) -> Optional[str]:
        """Recompute every frame leaf's sha256 against the header (the
        full-read check the lazy memmap ``get`` skips); npz blobs are
        fully decoded."""
        path = self._find(key)
        if path is None:
            raise FileNotFoundError(f"no blob {key!r} in {self.root}")
        try:
            if cio.is_frame_file(path):
                cio.read_frame(path, verify=True)
            else:
                cio.load_any(path, mmap=False)
        except FileNotFoundError:
            raise
        except Exception as e:
            return f"{type(e).__name__}: {e}"
        return None

    def sweep_orphans(self, min_age_s: float = 60.0, spare=()) -> int:
        """Remove ``.tmp`` debris of atomic writes that crashed before
        their rename (``<key>.<suffix>.<random>.tmp``); age-gated, and a
        key in ``spare`` keeps its file whatever its age."""
        spare = set(spare)
        removed = 0
        cutoff = time.time() - min_age_s
        for f in os.listdir(self.root):
            if not f.endswith(".tmp") or f.split(".", 1)[0] in spare:
                continue
            p = os.path.join(self.root, f)
            try:
                if os.path.getmtime(p) <= cutoff:
                    os.unlink(p)
                    removed += 1
            except OSError:
                pass
        return removed

    def keys(self) -> List[str]:
        out = set()
        for f in os.listdir(self.root):
            for suffix in self.SUFFIXES.values():
                if f.endswith(suffix):
                    out.add(f[:-len(suffix)])
        return sorted(out)

    def url(self, key: str) -> str:
        return self._find(key) or self._path(key)


# ----------------------------------------------------------------------
# CPU-memory tier with asynchronous write-back
# ----------------------------------------------------------------------

class MemoryTierBackend(StorageBackend):
    """CPU-RAM checkpoint tier (TierCheck / Gemini style).

    ``put`` copies the tree's leaves into host arrays the tier owns and
    returns; with a ``lower`` backend every put is also queued for
    asynchronous write-back of that copy, so the tiers never diverge
    whatever the caller does with its buffers after ``put`` (the port's
    snapshot leaves are views of pinned memory that the caching host
    allocator hands to the next snapshot). ``get`` copies out as well.

    ``capacity_bytes`` bounds resident bytes: a victim is evicted after
    its write-back lands. Victims come from size-class buckets
    (power-of-two ``nbytes`` classes), the bucket holding the most
    evictable bytes first; within it ``"fifo"`` evicts insertion order
    and ``"lru"`` least-recently-used (``get`` refreshes recency). Keys
    of the newest full's chain (``protect``) are never victims. A
    capacity without a lower tier would drop blobs the manifest still
    references, so it is rejected. A failed write-back is re-raised from
    ``flush()``.
    """

    name = "memory"
    EVICTION_POLICIES = ("fifo", "lru")

    def __init__(self, lower: Optional[StorageBackend] = None, *,
                 capacity_bytes: Optional[int] = None,
                 eviction: str = "fifo"):
        if capacity_bytes is not None and lower is None:
            raise ValueError(
                "capacity_bytes requires a lower backend to spill to; "
                "a pure-RAM tier must hold every live checkpoint")
        if eviction not in self.EVICTION_POLICIES:
            raise ValueError(f"eviction must be one of "
                             f"{self.EVICTION_POLICIES}")
        self.lower = lower
        self.persist_root = lower.persist_root if lower is not None else None
        self.fmt = lower.fmt if lower is not None else "memory"
        self.capacity_bytes = capacity_bytes
        self.eviction = eviction
        self._mem: "OrderedDict[str, Tuple[dict, List[np.ndarray], int]]" \
            = OrderedDict()
        self._bytes = 0
        #: size-class buckets: class -> insertion/recency-ordered keys,
        #: and each class's resident bytes (victim selection)
        self._buckets: Dict[int, "OrderedDict[str, None]"] = {}
        self._bucket_bytes: Dict[int, int] = {}
        self._class_of: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._writeback: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="spill")
            if lower is not None else None)
        self._inflight: Dict[str, Future] = {}
        #: write-backs that failed: re-raised from flush(), never pruned
        #: (the journal already references the blob)
        self._wb_errors: List[Tuple[str, BaseException]] = []
        #: the newest full's replay chain: never evicted
        self._protected: frozenset = frozenset()
        self.evictions = 0
        self.spills = 0
        self.evictions_skipped = 0

    # -- size-class bucket bookkeeping (callers hold self._lock) -------
    @staticmethod
    def _size_class(nbytes: int) -> int:
        return int(nbytes).bit_length()

    def _bucket_add(self, key: str, nbytes: int):
        c = self._size_class(nbytes)
        self._class_of[key] = c
        self._buckets.setdefault(c, OrderedDict())[key] = None
        self._buckets[c].move_to_end(key)
        self._bucket_bytes[c] = self._bucket_bytes.get(c, 0) + nbytes

    def _bucket_remove(self, key: str, nbytes: int):
        c = self._class_of.pop(key, None)
        if c is None:
            return
        self._buckets[c].pop(key, None)
        self._bucket_bytes[c] -= nbytes
        if not self._buckets[c]:
            del self._buckets[c], self._bucket_bytes[c]

    def _bucket_touch(self, key: str):
        c = self._class_of.get(key)
        if c is not None:
            self._buckets[c].move_to_end(key)

    def put(self, key: str, obj: Any) -> int:
        with trace_span("backend.put", "backend", tier=self.name,
                        key=key):
            return self._put_impl(key, obj)

    def _put_impl(self, key: str, obj: Any) -> int:
        struct, arrays = cio.pack(obj)
        # np.array COPIES: the tier owns its bytes
        arrays = [np.array(a) for a in arrays]
        nbytes = int(sum(a.nbytes for a in arrays))
        self._prune_done()
        with self._lock:
            if key in self._mem:
                self._bytes -= self._mem[key][2]
                self._bucket_remove(key, self._mem[key][2])
            self._mem[key] = (struct, arrays, nbytes)
            self._mem.move_to_end(key)
            self._bucket_add(key, nbytes)
            self._bytes += nbytes
        if self._writeback is not None:
            # write back the tier's own copy, not the caller's tree
            snap = cio.unpack(struct, arrays)
            fut = self._writeback.submit(self.lower.put, key, snap)
            self._inflight[key] = fut
            self.spills += 1
        self._evict()
        return nbytes

    def _prune_done(self):
        """Drop completed write-back futures (failed ones are recorded
        for flush())."""
        for k, fut in list(self._inflight.items()):
            if fut.done():
                err = fut.exception()
                if err is not None:
                    self._wb_errors.append((k, err))
                self._inflight.pop(k, None)

    def protect(self, keys) -> None:
        with self._lock:
            shrank = not self._protected <= frozenset(keys)
            self._protected = frozenset(keys)
        if shrank:
            # blobs a new full just un-protected can go now
            self._evict()

    def _pick_victim(self) -> Optional[str]:
        """Victim under the policy (caller holds the lock): the bucket
        with the most evictable bytes first, then its oldest (fifo) or
        least recently used (lru) unprotected key."""
        for c in sorted(self._bucket_bytes,
                        key=self._bucket_bytes.get, reverse=True):
            for k in self._buckets[c]:
                if k not in self._protected:
                    return k
        return None

    def _evict(self):
        if self.capacity_bytes is None:
            return
        while True:
            with self._lock:
                if self._bytes <= self.capacity_bytes or len(self._mem) <= 1:
                    return
                # soft cap: the protected chain may hold the tier over
                key = self._pick_victim()
                if key is None:
                    self.evictions_skipped += 1
                    return
            fut = self._inflight.pop(key, None)
            if fut is not None:
                fut.result()  # never drop RAM before the write-back lands
            with self._lock:
                item = self._mem.pop(key, None)
                if item is not None:
                    self._bytes -= item[2]
                    self._bucket_remove(key, item[2])
                    self.evictions += 1

    def get(self, key: str) -> Any:
        with self._lock:
            item = self._mem.get(key)
            if item is not None and self.eviction == "lru":
                self._mem.move_to_end(key)
                self._bucket_touch(key)
        if item is not None:
            struct, arrays, _ = item
            # copy out: callers may mutate the returned tree
            return cio.unpack(struct, [np.array(a) for a in arrays])
        if self.lower is not None:
            fut = self._inflight.get(key)
            if fut is not None:
                fut.result()
            return self.lower.get(key)
        raise FileNotFoundError(f"memory tier has no blob {key!r}")

    def patch(self, key: str, patch: PatchSet) -> int:
        """Patch the resident arrays in place (a whole-leaf span replaces
        the array with a copy; row spans are spliced in) and forward the
        patch to the lower tier through the same FIFO write-back worker,
        after the blob's own write-back."""
        ps = _patchset(patch)
        self._prune_done()
        n = 0
        with self._lock:
            item = self._mem.get(key)
            if item is not None:
                _, arrays, _ = item
                for name in ps:
                    i = int(name[1:])
                    base = arrays[i]
                    for sp in ps[name]:
                        a = np.asarray(sp.data)
                        whole = sp.start == 0 and a.shape == base.shape
                        if base.dtype != a.dtype or not (
                                whole or (base.ndim >= 1 and a.ndim >= 1
                                          and a.shape[1:] == base.shape[1:]
                                          and sp.stop <= base.shape[0])):
                            raise ValueError(
                                f"leaf {name!r} layout mismatch on "
                                f"{key!r}: rows [{sp.start}, {sp.stop}) "
                                f"of {a.dtype}{a.shape} != "
                                f"{base.dtype}{base.shape}")
                        if whole:
                            arrays[i] = base = np.array(a)
                        else:
                            if not base.flags.writeable:
                                base = np.array(base)
                                arrays[i] = base
                            base[sp.start:sp.stop] = a
                        n += int(a.nbytes)
        if item is None and self.lower is None:
            raise FileNotFoundError(f"memory tier has no blob {key!r}")
        if self._writeback is not None:
            snap = ps.copy()
            # a still-pending future for this key must not lose its
            # error: collect it inside the new task (the single FIFO
            # worker has finished it by then)
            prev = self._inflight.get(key)

            def run(prev=prev, snap=snap):
                if prev is not None:
                    err = prev.exception()
                    if err is not None:
                        self._wb_errors.append((key, err))
                return self.lower.patch(key, snap)

            self._inflight[key] = self._writeback.submit(run)
            self.spills += 1
            if item is None:
                n = snap.nbytes
        return n

    def delete(self, key: str) -> None:
        fut = self._inflight.pop(key, None)
        if fut is not None:
            fut.result()
        with self._lock:
            item = self._mem.pop(key, None)
            if item is not None:
                self._bytes -= item[2]
                self._bucket_remove(key, item[2])
        if self.lower is not None:
            self.lower.delete(key)

    def verify(self, key: str) -> Optional[str]:
        """Scrub the cold copy (RAM-only blobs verify trivially)."""
        if self.lower is not None:
            fut = self._inflight.get(key)
            if fut is not None:
                fut.result()
            if self.lower.exists(key):
                return self.lower.verify(key)
        with self._lock:
            if key in self._mem:
                return None
        raise FileNotFoundError(f"memory tier has no blob {key!r}")

    def sweep_orphans(self, min_age_s: float = 60.0, spare=()) -> int:
        """The lower tier's sweep, sparing also the keys whose
        write-back has not landed."""
        if self.lower is None:
            return 0
        return self.lower.sweep_orphans(
            min_age_s, set(spare) | set(self._inflight.copy()))

    def exists(self, key: str) -> bool:
        with self._lock:
            if key in self._mem:
                return True
        return self.lower.exists(key) if self.lower is not None else False

    def keys(self) -> List[str]:
        with self._lock:
            ks = set(self._mem)
        if self.lower is not None:
            ks.update(self.lower.keys())
        return sorted(ks)

    def url(self, key: str) -> str:
        return f"memory://{key}"

    def flush(self) -> None:
        for key in list(self._inflight):
            fut = self._inflight.pop(key, None)
            if fut is not None:
                try:
                    fut.result()
                except Exception as e:
                    self._wb_errors.append((key, e))
        if self._wb_errors:
            key, err = self._wb_errors[0]
            raise RuntimeError(
                f"async write-back of {key!r} failed "
                f"({len(self._wb_errors) - 1} more); the RAM tier still "
                f"holds the blob but the lower tier does not") from err
        if self.lower is not None:
            self.lower.flush()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            if self._writeback is not None:
                self._writeback.shutdown(wait=True)
            if self.lower is not None:
                self.lower.close()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            resident = len(self._mem)
            nbytes = self._bytes
        return {"backend": self.name, "resident_blobs": resident,
                "resident_bytes": nbytes, "evictions": self.evictions,
                "evictions_skipped": self.evictions_skipped,
                "protected": len(self._protected),
                "eviction_policy": self.eviction,
                "size_classes": len(self._buckets),
                "spills": self.spills,
                "writeback_errors": len(self._wb_errors),
                "lower": self.lower.stats() if self.lower else None}


# ----------------------------------------------------------------------
# Sharded concurrent backend
# ----------------------------------------------------------------------

def default_split_axis(arr: np.ndarray) -> Optional[int]:
    """Split axis of a leaf: its largest dimension (what the reference
    picks when no mesh is active)."""
    if not arr.shape:
        return None
    return int(np.argmax(arr.shape))


class ShardedBackend(StorageBackend):
    """Shard directories with concurrent shard I/O.

    Layout::

        <root>/<key>.meta.json            # struct + placement (commit point)
        <root>/shard_000/<key>.ckpt       # shard 0's leaf pieces (frame;
        <root>/shard_001/<key>.ckpt       # .npz with fmt="npz") ...

    ``put`` splits each leaf of at least ``split_threshold_bytes`` along
    ``split_axis_fn(arr)`` into ``num_shards`` pieces (``np.array_split``,
    so ragged extents work; a bf16 leaf splits as its uint16 view),
    places smaller leaves whole on the least-loaded shard, writes the
    shard files concurrently and fsync'd, then commits by atomically
    writing the meta file. ``get`` loads the shards concurrently and
    re-assembles every leaf bit-exactly.
    """

    name = "sharded"
    META_SUFFIX = ".meta.json"
    SHARD_SUFFIXES = {"frame": ".ckpt", "npz": ".npz"}

    def __init__(self, root: str, num_shards: int = 4, *,
                 split_threshold_bytes: int = 1 << 16,
                 split_axis_fn=default_split_axis,
                 max_workers: Optional[int] = None, fmt: str = "frame"):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if fmt not in self.SHARD_SUFFIXES:
            raise ValueError(f"fmt must be one of "
                             f"{tuple(self.SHARD_SUFFIXES)}")
        self.root = root
        self.persist_root = root
        self.num_shards = num_shards
        self.split_threshold_bytes = split_threshold_bytes
        self.split_axis_fn = split_axis_fn
        self.fmt = fmt
        os.makedirs(root, exist_ok=True)
        for k in range(num_shards):
            os.makedirs(self._shard_dir(k), exist_ok=True)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or num_shards,
            thread_name_prefix="shard-io")
        #: keys whose shard files are being written (meta not committed):
        #: the orphan sweep must not reap them
        self._active_puts: set = set()
        self._active_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _shard_dir(self, k: int) -> str:
        return os.path.join(self.root, f"shard_{k:03d}")

    def _shard_path(self, k: int, key: str,
                    fmt: Optional[str] = None) -> str:
        return os.path.join(self._shard_dir(k),
                            f"{key}{self.SHARD_SUFFIXES[fmt or self.fmt]}")

    def _find_shard(self, k: int, key: str) -> str:
        for fmt in sorted(self.SHARD_SUFFIXES, key=lambda f: f != self.fmt):
            p = self._shard_path(k, key, fmt)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"no shard file for {key!r} in {self._shard_dir(k)}")

    def _save_shard(self, k: int, key: str,
                    payload: Dict[str, np.ndarray]) -> int:
        if self.fmt == "frame":
            n = cio.save_frame_payload(self._shard_path(k, key), payload)
        else:
            n = cio.save_npz(self._shard_path(k, key), payload)
        for fmt in self.SHARD_SUFFIXES:   # drop a stale cross-format file
            if fmt != self.fmt:
                try:
                    os.unlink(self._shard_path(k, key, fmt))
                except FileNotFoundError:
                    pass
        return n

    def _load_shard(self, k: int, key: str) -> Dict[str, np.ndarray]:
        path = self._find_shard(k, key)
        if cio.is_frame_file(path):
            return cio.read_frame(path)[1]
        return cio.load_npz(path)

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}{self.META_SUFFIX}")

    def _read_meta(self, key: str) -> dict:
        try:
            with open(self._meta_path(key), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no sharded blob {key!r} in {self.root}") from None

    # ------------------------------------------------------------------
    def put(self, key: str, obj: Any) -> int:
        with self._active_lock:
            self._active_puts.add(key)
        try:
            with trace_span("backend.put", "backend", tier=self.name,
                            key=key, shards=self.num_shards):
                return self._put(key, obj)
        finally:
            with self._active_lock:
                self._active_puts.discard(key)

    def _put(self, key: str, obj: Any) -> int:
        struct, arrays = cio.pack(obj)
        payloads: List[Dict[str, np.ndarray]] = [
            {} for _ in range(self.num_shards)]
        loads = [0] * self.num_shards
        placements = []
        for i, arr in enumerate(arrays):
            arr = np.asarray(arr)
            axis = (self.split_axis_fn(arr)
                    if arr.nbytes >= self.split_threshold_bytes
                    and arr.ndim >= 1 else None)
            if (axis is not None and self.num_shards > 1
                    and arr.shape[axis] >= self.num_shards):
                pieces = np.array_split(arr, self.num_shards, axis=axis)
                for k, piece in enumerate(pieces):
                    payloads[k][f"a{i}"] = piece
                    loads[k] += piece.nbytes
                placements.append({"kind": "split", "axis": int(axis)})
            else:
                k = int(np.argmin(loads))
                payloads[k][f"a{i}"] = arr
                loads[k] += max(arr.nbytes, 1)
                placements.append({"kind": "whole", "shard": k})
        used = [k for k in range(self.num_shards) if payloads[k]]
        futs = {k: self._pool.submit(self._save_shard, k, key, payloads[k])
                for k in used}
        nbytes = sum(f.result() for f in futs.values())
        meta = {"struct": struct, "placements": placements, "shards": used,
                "num_shards": self.num_shards, "nbytes": nbytes,
                "format": self.fmt}
        meta_bytes = cio.atomic_write(
            self._meta_path(key),
            lambda f: f.write(json.dumps(meta).encode("utf-8")))
        return nbytes + meta_bytes

    def get(self, key: str) -> Any:
        meta = self._read_meta(key)
        futs = {k: self._pool.submit(self._load_shard, k, key)
                for k in meta["shards"]}
        shard_data = {k: f.result() for k, f in futs.items()}
        arrays: List[np.ndarray] = []
        for i, pl in enumerate(meta["placements"]):
            name = f"a{i}"
            if pl["kind"] == "whole":
                arrays.append(shard_data[pl["shard"]][name])
            else:
                pieces = [shard_data[k][name] for k in meta["shards"]
                          if name in shard_data[k]]
                arrays.append(np.concatenate(pieces, axis=pl["axis"]))
        return cio.unpack(meta["struct"], arrays)

    def patch(self, key: str, patch: PatchSet) -> int:
        """Re-split each span exactly as ``put`` placed its leaf (same
        axis, same ``array_split`` boundaries) and write the intersecting
        pieces into their shard frames concurrently. The meta file never
        changes."""
        ps = _patchset(patch)
        meta = self._read_meta(key)
        if meta.get("format", "npz") != "frame":
            raise ValueError(
                f"cannot patch npz shards of {key!r} in place; "
                f"incremental persistence requires the frame format")
        parts = int(meta["num_shards"])
        per_shard: Dict[int, PatchSet] = {}
        for name in ps:
            i = int(name[1:])
            pl = meta["placements"][i]
            shape = ps.shape_of(name)
            if pl["kind"] == "whole":
                tgt = per_shard.setdefault(pl["shard"], PatchSet())
                for sp in ps[name]:
                    tgt.add(name, sp.start, sp.data, shape)
                continue
            axis = int(pl["axis"])
            sizes = split_sizes(shape[axis], parts)
            bounds = np.cumsum([0] + sizes).tolist()
            for sp in ps[name]:
                a = np.asarray(sp.data)
                for k in range(parts):
                    lo, hi = int(bounds[k]), int(bounds[k + 1])
                    if lo == hi:
                        continue
                    if axis == 0:
                        # the split axis is the span axis: intersect the
                        # row range with this shard's slice
                        s, e = max(sp.start, lo), min(sp.stop, hi)
                        if s >= e:
                            continue
                        piece_shape = (sizes[k],) + tuple(shape[1:])
                        per_shard.setdefault(k, PatchSet()).add(
                            name, s - lo, a[s - sp.start:e - sp.start],
                            piece_shape)
                    else:
                        # split along a tail axis: every shard holds all
                        # rows, only the tail columns are sliced
                        sel = [slice(None)] * a.ndim
                        sel[axis] = slice(lo, hi)
                        piece_shape = tuple(
                            hi - lo if d == axis else shape[d]
                            for d in range(len(shape)))
                        per_shard.setdefault(k, PatchSet()).add(
                            name, sp.start, a[tuple(sel)], piece_shape)
        futs = {k: self._pool.submit(self._patch_shard, k, key, upd)
                for k, upd in per_shard.items()}
        return sum(f.result() for f in futs.values())

    def _patch_shard(self, k: int, key: str, updates: PatchSet) -> int:
        return cio.patch_frame(self._find_shard(k, key), updates)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._meta_path(key))
        except FileNotFoundError:
            pass
        # the shard dirs on disk, not range(num_shards): the blob may
        # have been written under another shard count or format
        for d in os.listdir(self.root):
            if not d.startswith("shard_"):
                continue
            for suffix in self.SHARD_SUFFIXES.values():
                try:
                    os.unlink(os.path.join(self.root, d, f"{key}{suffix}"))
                except FileNotFoundError:
                    pass

    def exists(self, key: str) -> bool:
        return os.path.exists(self._meta_path(key))

    def verify(self, key: str) -> Optional[str]:
        """Re-verify every shard file (frame shards recompute each
        piece's sha256, npz shards fully decode) after parsing the meta
        file."""
        try:
            meta = self._read_meta(key)
        except FileNotFoundError:
            raise
        except Exception as e:
            return f"meta: {type(e).__name__}: {e}"
        for k in meta["shards"]:
            try:
                path = self._find_shard(k, key)
                if cio.is_frame_file(path):
                    cio.read_frame(path, verify=True)
                else:
                    cio.load_npz(path)
            except Exception as e:
                # a missing shard under a committed meta is corruption
                return f"shard {k}: {type(e).__name__}: {e}"
        return None

    def sweep_orphans(self, min_age_s: float = 60.0, spare=()) -> int:
        """Reap shard files whose key has no committed meta file (a put
        that crashed before its commit point), skipping keys with a put
        in flight and the keys in ``spare``."""
        with self._active_lock:
            active = set(self._active_puts) | set(spare)
        removed = 0
        cutoff = time.time() - min_age_s
        for d in os.listdir(self.root):
            if not d.startswith("shard_"):
                continue
            for f in os.listdir(os.path.join(self.root, d)):
                for suffix in self.SHARD_SUFFIXES.values():
                    if not f.endswith(suffix):
                        continue
                    key = f[:-len(suffix)]
                    if key in active or self.exists(key):
                        continue
                    p = os.path.join(self.root, d, f)
                    try:
                        if os.path.getmtime(p) <= cutoff:
                            os.unlink(p)
                            removed += 1
                    except OSError:
                        pass
        return removed

    def keys(self) -> List[str]:
        n = len(self.META_SUFFIX)
        return sorted(f[:-n] for f in os.listdir(self.root)
                      if f.endswith(self.META_SUFFIX))

    def url(self, key: str) -> str:
        return self._meta_path(key)

    def close(self) -> None:
        self.flush()
        self._pool.shutdown(wait=True)

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.name, "num_shards": self.num_shards}


# ----------------------------------------------------------------------
# Factory
# ----------------------------------------------------------------------

BACKENDS = ("local", "memory", "sharded", "remote")


def make_backend(name: str, root: Optional[str], *, shards: int = 4,
                 capacity_mb: Optional[float] = None,
                 memory_spill: bool = True,
                 remote_url: Optional[str] = None,
                 chunk_mb: float = 4.0, max_retries: int = 4,
                 remote_fault_rate: float = 0.0,
                 fmt: str = "frame",
                 eviction: str = "fifo") -> StorageBackend:
    """Deprecated shim: build a backend by legacy name through
    :meth:`repro_torch.checkpoint.config.StoreConfig.from_legacy`."""
    import warnings
    warnings.warn(
        "make_backend() is deprecated; declare the tier stack with "
        "repro_torch.checkpoint.config.StoreConfig and call "
        "build_backend()", DeprecationWarning, stacklevel=2)
    from repro_torch.checkpoint.config import StoreConfig
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; choose from {BACKENDS}")
    if name == "local" and root is None:
        raise ValueError("local backend requires a root directory")
    if name == "sharded" and root is None:
        raise ValueError("sharded backend requires a root directory")
    if name == "remote" and remote_url is None and root is None:
        raise ValueError("remote backend requires --remote-url or a root "
                         "directory (which becomes file://<root>)")
    if name == "memory" and not memory_spill:
        root = None  # pure-RAM tier: no lower backend to spill to
    cfg = StoreConfig.from_legacy(
        root, backend=name, shards=shards, capacity_mb=capacity_mb,
        remote_url=remote_url, chunk_mb=chunk_mb, max_retries=max_retries,
        remote_fault_rate=remote_fault_rate, fmt=fmt, eviction=eviction)
    return cfg.build_backend()
