"""Remote object-store checkpoint tier (port of
``repro.checkpoint.remote``; the object layout and index are the
reference's, so each package reads the other's buckets).

* :class:`ObjectStore` — the byte-level client (put/get/delete/list),
  with two hermetic implementations: :class:`FakeObjectStore` (an
  in-process dict with optional fault injection and simulated latency)
  and :class:`FilesystemObjectStore` (a directory standing in for a
  mounted bucket, surviving process restarts).
* :class:`RemoteObjectBackend` — a :class:`~repro_torch.checkpoint.
  backends.StorageBackend` over any ObjectStore: blobs are cut into
  ``chunk_bytes`` chunks under a per-put generation prefix, every chunk
  carries a sha256, and an index object written *last* is the commit
  point. Reads verify each chunk and re-fetch a corrupt one; every
  transfer is retried with exponential backoff up to ``max_retries``
  times, then :class:`RetryExhaustedError` is raised.

The backend sits under a :class:`~repro_torch.checkpoint.backends.
MemoryTierBackend`, whose asynchronous write-back keeps object-store
latency off the training loop.
"""
from __future__ import annotations

import abc
import hashlib
import json
import os
import random
import struct as _struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import io as cio
from repro_torch.checkpoint.backends import StorageBackend
from repro_torch.checkpoint.patchset import PatchSet
from repro_torch.obs.trace import trace_span


class TransientStoreError(Exception):
    """A retryable object-store failure (timeout, dropped connection,
    throttling). :class:`RemoteObjectBackend` retries these."""


class ChecksumError(TransientStoreError):
    """A fetched chunk failed checksum verification; retryable — the
    next fetch may return clean bytes."""


class RetryExhaustedError(RuntimeError):
    """Bounded retries were exhausted without a successful transfer."""


# ----------------------------------------------------------------------
# fault injection
# ----------------------------------------------------------------------

class FaultInjector:
    """Configurable transient-fault schedule for hermetic stores.

    Deterministic counts are consumed first, in call order:

    * ``drop_puts`` — first N ``put_object`` calls raise
      :class:`TransientStoreError` (the chunk never lands).
    * ``drop_gets`` — first N ``get_object`` calls raise
      :class:`TransientStoreError`.
    * ``flip_gets`` — first N ``get_object`` calls return the stored
      bytes with one byte corrupted (a checksum flip in flight).

    After the counts are spent, ``rate`` injects random transient drops
    on both puts and gets with a seeded RNG — statistical soak mode for
    benchmarks. Thread-safe (the write-back thread and the reader race).
    """

    def __init__(self, *, drop_puts: int = 0, drop_gets: int = 0,
                 flip_gets: int = 0, rate: float = 0.0, seed: int = 0):
        self.drop_puts = drop_puts
        self.drop_gets = drop_gets
        self.flip_gets = flip_gets
        self.rate = rate
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected = 0

    def _roll(self) -> bool:
        return self.rate > 0.0 and self._rng.random() < self.rate

    def on_put(self, name: str) -> None:
        with self._lock:
            if self.drop_puts > 0:
                self.drop_puts -= 1
                self.injected += 1
                raise TransientStoreError(f"injected put drop: {name}")
            if self._roll():
                self.injected += 1
                raise TransientStoreError(f"injected put drop: {name}")

    def on_get(self, name: str, data: bytes) -> bytes:
        with self._lock:
            if self.drop_gets > 0:
                self.drop_gets -= 1
                self.injected += 1
                raise TransientStoreError(f"injected get drop: {name}")
            if self.flip_gets > 0 and data:
                self.flip_gets -= 1
                self.injected += 1
                return bytes([data[0] ^ 0xFF]) + data[1:]
            if self._roll():
                self.injected += 1
                raise TransientStoreError(f"injected get drop: {name}")
        return data


# ----------------------------------------------------------------------
# object-store clients
# ----------------------------------------------------------------------

class ObjectStore(abc.ABC):
    """Minimal byte-level object-store client. Names are '/'-separated
    path-safe strings; values are opaque byte blobs."""

    scheme = "abstract"

    @abc.abstractmethod
    def put_object(self, name: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def get_object(self, name: str) -> bytes:
        """Raises FileNotFoundError when the object is absent."""

    @abc.abstractmethod
    def delete_object(self, name: str) -> None:
        """Idempotent."""

    @abc.abstractmethod
    def list_objects(self, prefix: str = "") -> List[str]: ...

    def has_object(self, name: str) -> bool:
        """Metadata-only presence check (HEAD-style). The default
        downloads the body; real clients should override."""
        try:
            self.get_object(name)
            return True
        except FileNotFoundError:
            return False


class FakeObjectStore(ObjectStore):
    """In-process object store: a dict behind a lock, with optional
    fault injection and simulated per-byte latency. Hermetic stand-in
    for S3/GCS in tests and benchmarks."""

    scheme = "fake"

    def __init__(self, faults: Optional[FaultInjector] = None, *,
                 latency_s_per_mb: float = 0.0):
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.faults = faults
        self.latency_s_per_mb = latency_s_per_mb
        self.put_calls = 0
        self.get_calls = 0

    def _simulate_latency(self, nbytes: int):
        if self.latency_s_per_mb > 0.0:
            time.sleep(self.latency_s_per_mb * nbytes / 2**20)

    def put_object(self, name: str, data: bytes) -> None:
        with self._lock:
            self.put_calls += 1
        if self.faults is not None:
            self.faults.on_put(name)
        self._simulate_latency(len(data))
        with self._lock:
            self._objects[name] = bytes(data)

    def get_object(self, name: str) -> bytes:
        with self._lock:
            self.get_calls += 1
            data = self._objects.get(name)
        if data is None:
            raise FileNotFoundError(f"fake://{name}")
        if self.faults is not None:
            data = self.faults.on_get(name, data)
        self._simulate_latency(len(data))
        return data

    def delete_object(self, name: str) -> None:
        with self._lock:
            self._objects.pop(name, None)

    def list_objects(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(n for n in self._objects if n.startswith(prefix))

    def has_object(self, name: str) -> bool:
        with self._lock:
            return name in self._objects


class FilesystemObjectStore(ObjectStore):
    """A local directory standing in for a mounted bucket. Objects are
    files under ``root`` (atomic tmp+rename writes); '/' in names maps
    to subdirectories. Survives process restarts, so crash/recovery
    tests can model 'the bucket outlives the trainer'."""

    scheme = "file"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def put_object(self, name: str, data: bytes) -> None:
        cio.atomic_write(self._path(name), lambda f: f.write(data))

    def get_object(self, name: str) -> bytes:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise FileNotFoundError(f"file://{self._path(name)}")

    def delete_object(self, name: str) -> None:
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass

    def has_object(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def list_objects(self, prefix: str = "") -> List[str]:
        # a '/'-terminated directory component in the prefix scopes the
        # walk to that subtree — a per-key listing must not pay a
        # full-bucket scan
        base = self.root
        head = prefix.rsplit("/", 1)[0] if "/" in prefix else ""
        if head:
            base = os.path.join(self.root, *head.split("/"))
            if not os.path.isdir(base):
                return []
        out = []
        for dirpath, _, files in os.walk(base):
            rel = os.path.relpath(dirpath, self.root)
            for f in files:
                if f.endswith(".tmp"):
                    continue
                name = f if rel == "." else f"{rel}/{f}".replace(os.sep, "/")
                if name.startswith(prefix):
                    out.append(name)
        return sorted(out)


# ----------------------------------------------------------------------
# the storage backend
# ----------------------------------------------------------------------

def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class RemoteObjectBackend(StorageBackend):
    """StorageBackend over an :class:`ObjectStore` with chunking,
    per-chunk sha256 checksums, and bounded-retry transfers.

    Object layout per key::

        <key>/<gen>.000000.chunk ... <key>/<gen>.NNNNNN.chunk
        <key>/index.json      # chunk list + checksums (commit point)

    ``put`` streams the tree as a frame (:func:`~repro_torch.checkpoint.
    io.frame_chunks`) or as npz bytes (``fmt="npz"``) in ``chunk_bytes``
    pieces, uploads each with retries under a fresh generation ``gen``,
    then uploads the index — the commit point. ``get``
    fetches the index, then each chunk with checksum verification;
    a corrupted chunk is re-fetched (checksum mismatch is treated as a
    transient fault). Exhausted retries raise
    :class:`RetryExhaustedError`.

    ``journal_root`` is where the chain store's manifest journal lives
    (a *local* directory — the journal needs appendable files, which an
    object store does not give you). None means the manifest is held in
    memory only, which is fine for a FakeObjectStore whose contents die
    with the process anyway.
    """

    name = "remote"
    INDEX = "index.json"

    def __init__(self, store: ObjectStore, *, chunk_bytes: int = 4 << 20,
                 max_retries: int = 4, backoff_s: float = 0.01,
                 backoff_max_s: float = 2.0,
                 journal_root: Optional[str] = None, fmt: str = "frame"):
        if chunk_bytes < 1:
            raise ValueError("chunk_bytes must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if fmt not in cio.FORMATS:
            raise ValueError(f"fmt must be one of {cio.FORMATS}")
        self.fmt = fmt
        self.store = store
        self.chunk_bytes = chunk_bytes
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.persist_root = journal_root
        if journal_root is not None:
            os.makedirs(journal_root, exist_ok=True)
        self._lock = threading.Lock()
        #: key -> generation of the last index this backend committed;
        #: lets put() skip the stale-chunk sweep on first writes (the
        #: overwhelmingly common case under step-named keys)
        self._live_gens: Dict[str, str] = {}
        #: keys with an upload in flight (chunks landing, index not yet
        #: committed): the maintenance orphan sweep must not reap them
        self._active_puts: set = set()
        from repro_torch.obs.metrics import InstrumentSet
        self._inst = InstrumentSet("remote")
        #: stats() counter keys
        self.KEYS = ("puts", "gets", "patches", "retries",
                     "checksum_failures", "bytes_up", "bytes_down")
        for k in self.KEYS:
            self._inst.counter(k)

    def __getattr__(self, name):
        # legacy attribute surface: self.puts etc. read the counters
        if name != "KEYS" and name in getattr(self, "KEYS", ()):
            return int(self._inst.get(name).value)
        raise AttributeError(name)

    def instruments(self):
        """The backing :class:`~repro_torch.obs.metrics.InstrumentSet`."""
        return self._inst

    # ------------------------------------------------------------------
    def _count(self, attr: str, n: int = 1):
        self._inst.counter(attr).add(n)

    def _with_retries(self, fn, desc: str):
        delay = self.backoff_s
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except TransientStoreError as e:
                last = e
                if attempt == self.max_retries:
                    break              # budget spent: no sleep, no retry
                self._count("retries")
                time.sleep(min(delay, self.backoff_max_s))
                delay *= 2.0
        raise RetryExhaustedError(
            f"{desc}: no success in {self.max_retries + 1} attempts "
            f"(last: {last})") from last

    def _chunk_name(self, key: str, gen: str, i: int) -> str:
        return f"{key}/{gen}.{i:06d}.chunk"

    def _index_name(self, key: str) -> str:
        return f"{key}/{self.INDEX}"

    # ------------------------------------------------------------------
    def _chunk_iter(self, obj: Any):
        """Iterator of wire chunks (each <= chunk_bytes). The frame path
        streams zero-copy views straight out of the snapshot buffers;
        the npz path materializes the blob and re-slices it (two full
        host copies, metered)."""
        if self.fmt == "frame":
            payload, extra = cio.frame_payload(obj)
            return cio.frame_chunks(payload, self.chunk_bytes, extra)
        blob = cio.dumps(obj)          # copy 1 (metered inside dumps)
        cio.COPY_METER.add(len(blob))  # copy 2: the chunk re-slice below
        return (blob[o:o + self.chunk_bytes]
                for o in range(0, len(blob), self.chunk_bytes))

    def put(self, key: str, obj: Any) -> int:
        with self._lock:
            self._active_puts.add(key)
        try:
            with trace_span("backend.put", "backend", tier=self.name,
                            key=key):
                return self._put(key, obj)
        finally:
            with self._lock:
                self._active_puts.discard(key)

    def _put(self, key: str, obj: Any) -> int:
        # chunks carry a per-put generation prefix so a re-put never
        # overwrites the chunks the live index points at: until the new
        # index commits, the old version stays fully readable
        gen = os.urandom(4).hex()
        index = {"gen": gen, "format": self.fmt, "chunks": []}
        nbytes = 0
        for i, chunk in enumerate(self._chunk_iter(obj)):
            name = self._chunk_name(key, gen, i)
            self._with_retries(
                lambda n=name, c=chunk: self.store.put_object(n, c),
                f"put {name}")
            index["chunks"].append({"name": name, "sha256": _sha256(chunk),
                                    "size": len(chunk)})
            nbytes += len(chunk)
        index["nbytes"] = nbytes
        # the index is the commit point: a crash before this line leaves
        # no index (or the previous one), exists()/get() keep answering
        # for the last committed version, and the chain store's
        # _prune_missing drops a never-committed manifest entry on reopen
        index_bytes = json.dumps(index).encode()
        self._with_retries(
            lambda: self.store.put_object(self._index_name(key), index_bytes),
            f"put {self._index_name(key)}")
        self._count("puts")
        self._count("bytes_up", nbytes + len(index_bytes))
        with self._lock:
            prev = self._live_gens.get(key)
            self._live_gens[key] = gen
        if prev is not None and prev != gen:
            # only a re-put leaves a superseded generation; first writes
            # (every step-named key, i.e. nearly all of them) skip the
            # listing entirely
            self._sweep_stale(key, {c["name"] for c in index["chunks"]})
        return nbytes

    def _sweep_stale(self, key: str, live_names: set) -> None:
        """Best-effort GC of chunk objects the live index no longer
        references: superseded generations and crashed uploads. Liveness
        is the index's chunk *name list*, not a generation prefix — a
        patched index legitimately mixes generations, reusing unchanged
        chunks from older ones. Failures are harmless: orphans cost
        bucket bytes, never correctness."""
        for name in self.store.list_objects(f"{key}/"):
            if name == self._index_name(key) or name in live_names:
                continue
            try:
                self.store.delete_object(name)
            except TransientStoreError:
                pass

    # ------------------------------------------------------------------
    # in-place patching (incremental-merging persistence)
    # ------------------------------------------------------------------
    def _read_frame_header(self, chunks: List[dict]
                           ) -> Tuple[dict, int, int, Dict[int, bytes]]:
        """Fetch just enough leading chunks to parse the frame header.
        Returns (header dict, header json byte length, data_start,
        fetched chunk bytes by index — the caller splices into these
        same chunks, so re-downloading them would double the traffic)."""
        magic_len = len(cio.FRAME_MAGIC)
        head = bytearray()
        fetched: Dict[int, bytes] = {}
        ci = 0
        need = magic_len + 8
        hlen = 0
        while True:
            if len(head) >= magic_len + 8:
                (hlen,) = _struct.unpack(
                    "<Q", bytes(head[magic_len:magic_len + 8]))
                need = magic_len + 8 + hlen
                if len(head) >= need:
                    break
            if ci >= len(chunks):
                raise cio.FrameCorruptionError(
                    "remote frame shorter than its header")
            fetched[ci] = self._fetch_chunk(chunks[ci])
            head += fetched[ci]
            ci += 1
        if bytes(head[:magic_len]) != cio.FRAME_MAGIC:
            raise cio.FrameCorruptionError(
                "remote blob is not a frame (bad magic)")
        header = json.loads(bytes(head[magic_len + 8:need]).decode("utf-8"))
        return header, hlen, need + (-need) % cio.FRAME_ALIGN, fetched

    def patch(self, key: str, patch: PatchSet) -> int:
        with self._lock:
            self._active_puts.add(key)
        try:
            return self._patch(key, patch)
        finally:
            with self._lock:
                self._active_puts.discard(key)

    def _patch(self, key: str, patch: PatchSet) -> int:
        """Re-put only the chunk objects a dirty row range's bytes (or
        the rewritten header) intersect, under a fresh generation; the
        new index references the new chunks *and* every untouched chunk
        of the previous generation by name — unchanged bytes are never
        re-uploaded. A partially-patched leaf's sha256 must cover its
        retained rows too, so those (and only those) chunks are
        downloaded once and spliced. The index write is the commit
        point, exactly as in ``put``: a crash mid-patch leaves the old
        index live and only orphan chunks behind."""
        ps = PatchSet.coerce(patch)
        index = self._load_index(key)
        if index.get("format", "npz") != "frame":
            raise ValueError(
                f"cannot patch npz remote blob {key!r} in place; "
                f"incremental persistence requires the frame format")
        chunks = list(index["chunks"])
        header, hlen, data_start, fetched = self._read_frame_header(chunks)
        down = [sum(len(b) for b in fetched.values())]
        offs = [0]
        for c in chunks:
            offs.append(offs[-1] + int(c["size"]))

        def read_range(lo: int, hi: int) -> bytes:
            """Committed frame bytes [lo, hi), fetching (and caching)
            only the chunks the range touches."""
            out = bytearray(hi - lo)
            for i, c in enumerate(chunks):
                clo, chi = offs[i], offs[i + 1]
                if chi <= lo or clo >= hi:
                    continue
                b = fetched.get(i)
                if b is None:
                    b = self._fetch_chunk(c)
                    fetched[i] = b
                    down[0] += len(b)
                s, e = max(lo, clo), min(hi, chi)
                out[s - lo:e - lo] = b[s - clo:e - clo]
            return bytes(out)

        by_name = {leaf["name"]: leaf for leaf in header["leaves"]}
        magic_len = len(cio.FRAME_MAGIC)
        # dirty byte ranges: each patched span, plus the header rewrite
        ranges: List[Tuple[int, bytes]] = []
        for name in ps:
            rec = by_name.get(name)
            if rec is None:
                raise ValueError(f"remote frame {key!r} has no leaf {name!r}")
            rshape = tuple(rec["shape"])
            rows = rshape[0] if rshape else 1
            stride = int(rec["nbytes"]) // rows if rows else 0
            leaf_lo = data_start + rec["offset"]
            span_raws: List[Tuple[int, bytes]] = []
            for sp in ps[name]:
                a = np.asarray(sp.data)
                span_rows = int(a.shape[0]) if a.ndim else 1
                if a.dtype.str != rec["dtype"] or (
                        (sp.start != 0 or list(a.shape) != rec["shape"])
                        and (not rshape or a.ndim == 0
                             or a.shape[1:] != rshape[1:]
                             or sp.start + span_rows > rows)):
                    raise ValueError(
                        f"leaf {name!r} layout mismatch on {key!r}: rows "
                        f"[{sp.start}, {sp.start + span_rows}) of "
                        f"{a.dtype.str}{a.shape} != {rec['dtype']}{rshape}")
                raw = np.ascontiguousarray(a).tobytes()
                ranges.append((leaf_lo + sp.start * stride, raw))
                span_raws.append((sp.start * stride, raw))
            if ps.is_whole(name):
                rec["sha256"] = _sha256(span_raws[0][1])
            else:
                # digest spans committed-retained + patched bytes
                buf = bytearray(read_range(leaf_lo,
                                           leaf_lo + int(rec["nbytes"])))
                for off, raw in span_raws:
                    buf[off:off + len(raw)] = raw
                rec["sha256"] = _sha256(bytes(buf))
        hjson = json.dumps(header).encode("utf-8")
        if len(hjson) != hlen:
            raise ValueError(f"patched header for {key!r} length diverged "
                             f"({len(hjson)} != {hlen})")
        ranges.append((magic_len + 8, hjson))
        gen = os.urandom(4).hex()
        new_chunks: List[dict] = []
        nbytes_up = 0
        lo = 0
        for i, c in enumerate(chunks):
            hi = lo + int(c["size"])
            touching = [(o, b) for o, b in ranges
                        if o < hi and o + len(b) > lo]
            if not touching:
                new_chunks.append(c)          # reuse by name: not re-put
            else:
                old = fetched.get(i)
                if old is None:
                    old = self._fetch_chunk(c)
                    down[0] += len(old)
                data = bytearray(old)
                for o, b in touching:
                    s, e = max(lo, o), min(hi, o + len(b))
                    data[s - lo:e - lo] = b[s - o:e - o]
                blob = bytes(data)
                name = self._chunk_name(key, gen, i)
                self._with_retries(
                    lambda n=name, d=blob: self.store.put_object(n, d),
                    f"put {name}")
                new_chunks.append({"name": name, "sha256": _sha256(blob),
                                   "size": len(blob)})
                nbytes_up += len(blob)
            lo = hi
        new_index = {"gen": gen, "format": "frame", "chunks": new_chunks,
                     "nbytes": index["nbytes"]}
        index_bytes = json.dumps(new_index).encode()
        self._with_retries(
            lambda: self.store.put_object(self._index_name(key), index_bytes),
            f"put {self._index_name(key)}")
        self._count("patches")
        self._count("bytes_up", nbytes_up + len(index_bytes))
        self._count("bytes_down", down[0])
        with self._lock:
            self._live_gens[key] = gen
        self._sweep_stale(key, {c["name"] for c in new_chunks})
        return nbytes_up + len(index_bytes)

    def _load_index(self, key: str) -> dict:
        def fetch():
            data = self.store.get_object(self._index_name(key))
            try:
                return json.loads(data.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                # a corrupted index is as retryable as a corrupted chunk
                self._count("checksum_failures")
                raise ChecksumError(
                    f"index for {key!r} failed to parse") from e
        return self._with_retries(fetch, f"get {self._index_name(key)}")

    def _fetch_chunk(self, entry: dict) -> bytes:
        def fetch():
            data = self.store.get_object(entry["name"])
            if _sha256(data) != entry["sha256"]:
                self._count("checksum_failures")
                raise ChecksumError(
                    f"chunk {entry['name']} checksum mismatch")
            return data
        return self._with_retries(fetch, f"get {entry['name']}")

    def get(self, key: str) -> Any:
        index = self._load_index(key)
        blob = b"".join(self._fetch_chunk(e) for e in index["chunks"])
        self._count("gets")
        self._count("bytes_down", len(blob))
        # magic-sniffed: old npz uploads and new frame uploads both load
        # (chunk sha256s already verified each piece in _fetch_chunk)
        return cio.loads_any(blob)

    def delete(self, key: str) -> None:
        # index first: a crash mid-delete leaves orphan chunks (harmless,
        # swept by the next delete) rather than an index pointing at
        # missing chunks
        self.store.delete_object(self._index_name(key))
        for name in self.store.list_objects(f"{key}/"):
            self.store.delete_object(name)
        with self._lock:
            self._live_gens.pop(key, None)

    def verify(self, key: str) -> Optional[str]:
        """Scrub hook: re-fetch the index and every chunk, checking each
        sha256, without deserializing the tree. A checksum that stays
        wrong through the bounded retries is *corruption* (returned as a
        reason, the caller quarantines); transient-exhaustion on clean
        infrastructure errors propagates — a flaky wire must not
        quarantine an intact blob."""
        try:
            index = self._load_index(key)
        except FileNotFoundError:
            raise
        except RetryExhaustedError as e:
            if isinstance(e.__cause__, ChecksumError):
                return f"index for {key!r} unparseable"
            raise
        for entry in index["chunks"]:
            try:
                self._fetch_chunk(entry)
            except FileNotFoundError:
                return f"chunk {entry['name']} missing under live index"
            except RetryExhaustedError as e:
                if isinstance(e.__cause__, ChecksumError):
                    return f"chunk {entry['name']} sha256 mismatch"
                raise
        return None

    def sweep_orphans(self, min_age_s: float = 60.0, spare=()) -> int:
        """Reap chunk objects no committed index references: superseded
        generations a crashed re-put never swept, and uploads that died
        before their commit point. Keys with a put in flight (this
        backend is the single writer for its key space) and the keys in
        ``spare`` are skipped.
        Object stores expose no reliable mtime here, so ``min_age_s``
        is advisory only. Failures are harmless — orphans cost bucket
        bytes, never correctness."""
        with self._lock:
            active = set(self._active_puts) | set(spare)
        by_key: Dict[str, List[str]] = {}
        for name in self.store.list_objects():
            if "/" not in name:
                continue
            key, _, leaf = name.rpartition("/")
            if leaf == self.INDEX:
                continue
            by_key.setdefault(key, []).append(name)
        removed = 0
        for key, names in by_key.items():
            if key in active:
                continue
            try:
                # liveness = the names the index references (a patched
                # index mixes generations), not a generation prefix
                live = {c["name"]
                        for c in self._load_index(key)["chunks"]}
            except FileNotFoundError:
                live = None              # no commit point: all orphans
            except (RetryExhaustedError, TransientStoreError):
                continue                 # unreadable index: leave alone
            for name in names:
                if live is not None and name in live:
                    continue
                try:
                    self.store.delete_object(name)
                    removed += 1
                except TransientStoreError:
                    pass
        return removed

    def exists(self, key: str) -> bool:
        # metadata-only, but still fault-prone on a real wire: retry
        # transients rather than mis-reporting a reachable blob as
        # missing (which would make _prune_missing drop live chain
        # entries on reopen)
        return self._with_retries(
            lambda: self.store.has_object(self._index_name(key)),
            f"head {self._index_name(key)}")

    def keys(self) -> List[str]:
        suffix = f"/{self.INDEX}"
        return sorted(n[:-len(suffix)] for n in self.store.list_objects()
                      if n.endswith(suffix))

    def url(self, key: str) -> str:
        return f"{self.store.scheme}://{key}"

    def flush(self) -> None:
        """Puts are synchronous at this tier; nothing buffered."""

    def close(self) -> None:
        self.flush()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"backend": self.name, "scheme": self.store.scheme,
                    "chunk_bytes": self.chunk_bytes,
                    "puts": self.puts, "gets": self.gets,
                    "patches": self.patches, "retries": self.retries,
                    "checksum_failures": self.checksum_failures,
                    "bytes_up": self.bytes_up,
                    "bytes_down": self.bytes_down}


# ----------------------------------------------------------------------
# URL factory
# ----------------------------------------------------------------------

#: shared fake buckets: two make_remote_backend("fake://name") calls in
#: one process see the same objects, so in-process recovery works.
_FAKE_BUCKETS: Dict[str, FakeObjectStore] = {}
_FAKE_LOCK = threading.Lock()


def make_remote_backend(url: str, *, chunk_bytes: int = 4 << 20,
                        max_retries: int = 4,
                        journal_root: Optional[str] = None,
                        fault_rate: float = 0.0,
                        seed: int = 0,
                        fmt: str = "frame") -> RemoteObjectBackend:
    """Build a RemoteObjectBackend from a URL.

    * ``fake://<bucket>`` — in-process store, shared per bucket name
      within the process. The fault configuration is applied on every
      call (last caller wins): ``fault_rate`` > 0 attaches a fresh
      statistical injector, 0 detaches any previous one — a cached
      bucket never silently keeps a stale fault schedule.
    * ``file:///path`` — directory-backed store; objects land under
      ``<path>/objects`` and the manifest journal under ``<path>``
      unless ``journal_root`` overrides it.

    Real S3/GCS schemes are not bundled (no SDK in the image): pass a
    custom :class:`ObjectStore` to :class:`RemoteObjectBackend` instead.
    """
    scheme, sep, rest = url.partition("://")
    if not sep:
        raise ValueError(f"remote url {url!r} needs a scheme://")
    if scheme == "fake":
        bucket = rest or "default"
        with _FAKE_LOCK:
            store = _FAKE_BUCKETS.get(bucket)
            if store is None:
                store = FakeObjectStore()
                _FAKE_BUCKETS[bucket] = store
            # reconfigure faults on every call, cached bucket or not
            store.faults = (FaultInjector(rate=fault_rate, seed=seed)
                            if fault_rate > 0.0 else None)
        return RemoteObjectBackend(store, chunk_bytes=chunk_bytes,
                                   max_retries=max_retries,
                                   journal_root=journal_root, fmt=fmt)
    if scheme == "file":
        root = rest
        if not root:
            raise ValueError("file:// remote url needs a path")
        store = FilesystemObjectStore(os.path.join(root, "objects"))
        return RemoteObjectBackend(
            store, chunk_bytes=chunk_bytes, max_retries=max_retries,
            journal_root=journal_root if journal_root is not None else root,
            fmt=fmt)
    raise ValueError(
        f"unsupported remote scheme {scheme!r}: this build bundles "
        f"fake:// and file:// (implement ObjectStore for real buckets)")
