"""Atomic tree checkpoint serialization: streamed frames and legacy npz
(port of ``repro.checkpoint.io``, byte-compatible with it).

* **Frame** (the fast path)::

      RFRAME01 | header_len u64le | JSON header | pad -> 64B | leaf buffers

  The JSON header carries the structure descriptor plus one record per
  leaf: byte ``offset`` (relative to the 64-byte-aligned data section),
  ``nbytes``, ``dtype``, ``shape`` and ``sha256``. Every leaf buffer is
  64-byte aligned. Writers stream leaf by leaf; readers map the file
  with ``np.memmap``. The same tree written by either package gives the
  same bytes, and each package reads the other's frames.
  :func:`frame_chunks` cuts a frame into the chunk objects of the remote
  tier, with the reference's coalescing rules.
* **npz** (the seed format): an uncompressed zip of ``.npy`` buffers
  ``a0..aN`` plus the JSON structure as ``__struct__``. Zip members
  carry timestamps, so npz bytes are not stable; decoded arrays and the
  structure are. :func:`load_any` / :func:`loads_any` sniff the magic.

The codec covers the containers of the lowdiff and lowdiff_plus paths:
dict, list, tuple, NamedTuple (keyed by class name — ``AdamState``,
``RowUpdate``), ``SparseGrad`` (indices written as int32 under
``"__t": "sparse"``, as the reference writes them), ``QuantGrad``
(``"__t": "quant"``, scale (nb,)), ``PackedDiff`` (``"__t": "packed"``,
indices narrowed to int16 on the wire and widened back to int32 on
load), ``QuantSpan`` (``"__t": "qspan"``, wire bytes verbatim), torch
tensors, numpy arrays and python scalars. bfloat16 leaves are stored as
uint16 views referenced by negative index and come back as torch
bfloat16 tensors.

Writes go through :func:`atomic_write` (temp file + fsync + rename +
parent-directory fsync), so readers never observe a torn checkpoint.
:func:`patch_frame` rewrites row ranges of a frame in place (the fold
of an incremental patch chain into its base).
"""
from __future__ import annotations

import hashlib
import io as _io
import json
import os
import struct as _struct
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.patchset import PatchSet, RowUpdate
from repro_torch.compression.packed import PackedDiff
from repro_torch.compression.quant import QuantGrad
from repro_torch.compression.quant_span import QuantSpan
from repro_torch.compression.sparse import SparseGrad
from repro_torch.optim.adam import AdamState

FRAME_MAGIC = b"RFRAME01"
FRAME_ALIGN = 64
FORMATS = ("frame", "npz")

_NAMEDTUPLES: Dict[str, type] = {}


def register_namedtuple(cls) -> type:
    _NAMEDTUPLES[cls.__name__] = cls
    return cls


register_namedtuple(AdamState)
register_namedtuple(RowUpdate)


class FrameCorruptionError(ValueError):
    """A frame failed structural validation or a leaf sha256 check."""


class CopyMeter:
    """Process-wide counter of host-side copies of tensor bytes, with the
    two PCIe directions the checkpoint pipeline moves tensor bytes over:
    D2H snapshot transfers (``wait_s`` blocked vs ``span_s`` issue-to-
    landed, so ``d2h_overlap_ratio`` reports how much of the transfer hid
    behind compute) and H2D recovery-replay uploads."""

    KEYS = ("bytes", "events", "h2d_bytes", "h2d_events", "d2h_bytes",
            "d2h_events", "d2h_wait_s", "d2h_span_s")

    def __init__(self):
        from repro_torch.obs.metrics import InstrumentSet
        self._inst = InstrumentSet("copy_meter")
        self._bytes = self._inst.counter("bytes")
        self._events = self._inst.counter("events")
        self._h2d_bytes = self._inst.counter("h2d_bytes")
        self._h2d_events = self._inst.counter("h2d_events")
        self._d2h_bytes = self._inst.counter("d2h_bytes")
        self._d2h_events = self._inst.counter("d2h_events")
        self._d2h_wait = self._inst.histogram("d2h_wait_s")
        self._d2h_span = self._inst.histogram("d2h_span_s")

    @property
    def bytes(self) -> int:
        return int(self._bytes.value)

    @property
    def events(self) -> int:
        return int(self._events.value)

    @property
    def h2d_bytes(self) -> int:
        return int(self._h2d_bytes.value)

    @property
    def h2d_events(self) -> int:
        return int(self._h2d_events.value)

    @property
    def d2h_bytes(self) -> int:
        return int(self._d2h_bytes.value)

    @property
    def d2h_events(self) -> int:
        return int(self._d2h_events.value)

    @property
    def d2h_wait_s(self) -> float:
        return self._d2h_wait.sum

    @property
    def d2h_span_s(self) -> float:
        return self._d2h_span.sum

    def add(self, nbytes: int) -> None:
        self._bytes.add(int(nbytes))
        self._events.add(1)

    def add_h2d(self, nbytes: int) -> None:
        self._h2d_bytes.add(int(nbytes))
        self._h2d_events.add(1)

    def add_d2h(self, nbytes: int, *, wait_s: float = 0.0,
                span_s: float = 0.0) -> None:
        self._d2h_bytes.add(int(nbytes))
        self._d2h_events.add(1)
        self._d2h_wait.observe(float(wait_s))
        self._d2h_span.observe(float(span_s))

    def d2h_overlap_ratio(self) -> Optional[float]:
        span = self._d2h_span.sum
        if span <= 0.0:
            return None
        return max(0.0, 1.0 - self._d2h_wait.sum / span)

    def stats(self) -> Dict[str, Any]:
        out = {k: getattr(self, k) for k in self.KEYS}
        out["d2h_overlap_ratio"] = self.d2h_overlap_ratio()
        return out


COPY_METER = CopyMeter()


# ----------------------------------------------------------------------
# tree <-> (struct, arrays) codec
# ----------------------------------------------------------------------

def _pack(obj, arrays: List[np.ndarray]):
    """Recursively encode obj into JSON-able structure + array list."""
    if isinstance(obj, SparseGrad):
        return {"__t": "sparse", "shape": [int(d) for d in obj.shape],
                "block": int(obj.block),
                "values": _arr(obj.values, arrays),
                "indices": _arr(obj.indices, arrays)}
    if isinstance(obj, QuantGrad):
        return {"__t": "quant", "shape": [int(d) for d in obj.shape],
                "block": int(obj.block), "q": _arr(obj.q, arrays),
                "scale": _arr(obj.scale, arrays)}
    if isinstance(obj, PackedDiff):
        # block-local indices (< block <= 32768) narrow losslessly to
        # int16 on the wire, as the reference writes them
        idx = to_numpy(obj.indices)
        if obj.block <= np.iinfo(np.int16).max + 1:
            idx = idx.astype(np.int16)
        return {"__t": "packed", "shape": [int(d) for d in obj.shape],
                "block": int(obj.block), "q": _arr(obj.q, arrays),
                "indices": _arr(idx, arrays),
                "scale": _arr(obj.scale, arrays)}
    if isinstance(obj, QuantSpan):
        return {"__t": "qspan", "shape": list(obj.shape),
                "bits": int(obj.bits), "dtype": str(obj.dtype),
                "starts": [int(s) for s in obj.starts],
                "qs": [_arr(q, arrays) for q in obj.qs],
                "scales": [_arr(s, arrays) for s in obj.scales]}
    if isinstance(obj, dict):
        return {"__t": "dict",
                "items": {k: _pack(v, arrays) for k, v in obj.items()}}
    if hasattr(obj, "_fields"):  # NamedTuple
        return {"__t": "nt", "cls": type(obj).__name__,
                "items": {f: _pack(getattr(obj, f), arrays)
                          for f in obj._fields}}
    if isinstance(obj, (list, tuple)):
        return {"__t": "list" if isinstance(obj, list) else "tuple",
                "items": [_pack(v, arrays) for v in obj]}
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        return {"__t": "arr", "i": _arr(obj, arrays)}
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return {"__t": "py", "v": obj}
    raise TypeError(f"cannot checkpoint {type(obj)}")


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a leaf (bf16 as its uint16 bit pattern)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(x)


def _arr(x, arrays: List[np.ndarray]) -> int:
    bf16 = (isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16) or \
        (isinstance(x, np.ndarray) and x.dtype.name == "bfloat16")
    a = to_numpy(x)
    if bf16:
        arrays.append(a.view(np.uint16))
        return -len(arrays)  # negative index marks bf16 view
    arrays.append(a)
    return len(arrays) - 1


def _unpack(node, arrays):
    t = node["__t"]
    if t == "sparse":
        return SparseGrad(_get(node["values"], arrays),
                          _get(node["indices"], arrays),
                          tuple(node["shape"]), node["block"])
    if t == "quant":
        return QuantGrad(_get(node["q"], arrays), _get(node["scale"], arrays),
                         tuple(node["shape"]), node["block"])
    if t == "packed":
        return PackedDiff(_get(node["q"], arrays),
                          np.asarray(_get(node["indices"], arrays),
                                     np.int32),
                          _get(node["scale"], arrays),
                          tuple(node["shape"]), node["block"])
    if t == "qspan":
        return QuantSpan(starts=tuple(int(s) for s in node["starts"]),
                         qs=[np.asarray(_get(i, arrays))
                             for i in node["qs"]],
                         scales=[np.asarray(_get(i, arrays))
                                 for i in node["scales"]],
                         shape=tuple(node["shape"]), bits=int(node["bits"]),
                         dtype=node["dtype"])
    if t == "dict":
        return {k: _unpack(v, arrays) for k, v in node["items"].items()}
    if t == "nt":
        cls = _NAMEDTUPLES[node["cls"]]
        return cls(**{k: _unpack(v, arrays) for k, v in node["items"].items()})
    if t == "list":
        return [_unpack(v, arrays) for v in node["items"]]
    if t == "tuple":
        return tuple(_unpack(v, arrays) for v in node["items"])
    if t == "arr":
        return _get(node["i"], arrays)
    if t == "py":
        return node["v"]
    raise TypeError(f"leaf container {t!r} is not ported")


def _get(i: int, arrays):
    if i < 0:
        a = np.array(arrays[f"a{-i - 1}"]).view(np.int16)
        return torch.from_numpy(a).view(torch.bfloat16)
    return arrays[f"a{i}"]


def pack(obj: Any) -> Tuple[dict, List[np.ndarray]]:
    """Encode obj into (JSON-able structure, flat host-array list)."""
    arrays: List[np.ndarray] = []
    struct = _pack(obj, arrays)
    return struct, arrays


def unpack(struct: dict, arrays) -> Any:
    """Inverse of :func:`pack`. ``arrays``: mapping ``a0..aN`` or list."""
    if isinstance(arrays, (list, tuple)):
        arrays = {f"a{i}": a for i, a in enumerate(arrays)}
    return _unpack(struct, arrays)


# ----------------------------------------------------------------------
# atomic file writes
# ----------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, write_fn) -> int:
    """Crash-safe file write: mkstemp in the target directory,
    ``write_fn(binary_file)``, flush+fsync, ``os.replace``, then fsync
    the parent directory. Returns bytes written. The temporary file is
    named ``<basename>.<random>.tmp``, so an orphan sweep can tell which
    key a half-written file belongs to."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(parent)
    return os.path.getsize(path)


# ----------------------------------------------------------------------
# legacy npz encoding
# ----------------------------------------------------------------------

def save_npz(path: str, payload: Dict[str, np.ndarray]) -> int:
    """Atomic + fsync'd raw npz write. Returns bytes written."""
    return atomic_write(path, lambda f: np.savez(f, **payload))


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Fully materialize an npz written by :func:`save_npz`."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def payload_of(obj: Any) -> Dict[str, np.ndarray]:
    """The npz payload of obj: ``a0..aN`` plus the JSON structure as a
    uint8 ``__struct__`` member (every npz writer emits exactly this)."""
    struct, arrays = pack(obj)
    payload = {f"a{i}": a for i, a in enumerate(arrays)}
    payload["__struct__"] = np.frombuffer(
        json.dumps(struct).encode(), dtype=np.uint8)
    return payload


def dumps(obj: Any) -> bytes:
    """npz bytes of obj in memory (the remote tier's npz path); the
    materialized blob reports to the copy meter."""
    buf = _io.BytesIO()
    np.savez(buf, **payload_of(obj))
    data = buf.getvalue()
    COPY_METER.add(len(data))
    return data


def _npz_unpack(z) -> Any:
    struct = json.loads(bytes(z["__struct__"]).decode())
    return _unpack(struct, z)


def loads(data: bytes) -> Any:
    """Inverse of :func:`dumps`."""
    with np.load(_io.BytesIO(data)) as z:
        return _npz_unpack(z)


def save(path: str, obj: Any) -> int:
    """Atomic npz write of a tree. Returns bytes written."""
    return save_npz(path, payload_of(obj))


def load(path: str) -> Any:
    """Load a checkpoint file of either format (magic-sniffed)."""
    return load_any(path)


# ----------------------------------------------------------------------
# streamed frame format
# ----------------------------------------------------------------------

def _byte_view(a: np.ndarray) -> np.ndarray:
    """Flat uint8 view of a C-contiguous array (zero-copy)."""
    flat = a.reshape(-1) if a.ndim != 1 else a
    if flat.size == 0:
        return np.empty(0, np.uint8)
    return flat.view(np.uint8)


def frame_payload(obj: Any) -> Tuple[Dict[str, np.ndarray], dict]:
    struct, arrays = pack(obj)
    payload = {f"a{i}": a for i, a in enumerate(arrays)}
    return payload, {"struct": struct}


def _frame_plan(payload: Dict[str, np.ndarray],
                extra: Optional[dict]) -> Tuple[bytes, List[np.ndarray],
                                                List[int], int]:
    """Lay the frame out: (prefix bytes, contiguous arrays, per-leaf
    pad-before sizes, total frame bytes)."""
    names = list(payload)
    arrays = [a if a.flags.c_contiguous else np.ascontiguousarray(a)
              for a in (np.asarray(payload[n]) for n in names)]
    leaves, pads, rel = [], [], 0
    for name, a in zip(names, arrays):
        pad = (-rel) % FRAME_ALIGN
        rel += pad
        pads.append(pad)
        view = _byte_view(a)
        leaves.append({"name": name, "offset": rel, "nbytes": int(a.nbytes),
                       "dtype": a.dtype.str, "shape": list(a.shape),
                       "sha256": hashlib.sha256(view).hexdigest()})
        rel += a.nbytes
    header = {"version": 1, "leaves": leaves, "data_bytes": rel}
    if extra:
        header.update(extra)
    hjson = json.dumps(header).encode("utf-8")
    pre = len(FRAME_MAGIC) + 8 + len(hjson)
    hpad = (-pre) % FRAME_ALIGN
    prefix = (FRAME_MAGIC + _struct.pack("<Q", len(hjson)) + hjson
              + b"\0" * hpad)
    return prefix, arrays, pads, len(prefix) + rel


def frame_segments(payload: Dict[str, np.ndarray],
                   extra: Optional[dict] = None
                   ) -> Tuple[int, Iterator[Any]]:
    """(total_bytes, iterator of buffers) for a frame."""
    prefix, arrays, pads, total = _frame_plan(payload, extra)

    def gen():
        yield prefix
        for pad, a in zip(pads, arrays):
            if pad:
                yield b"\0" * pad
            if a.nbytes:
                yield _byte_view(a)

    return total, gen()


def write_frame(f, payload: Dict[str, np.ndarray],
                extra: Optional[dict] = None) -> int:
    total, segs = frame_segments(payload, extra)
    for seg in segs:
        f.write(seg)
    return total


#: segments at or below this size are coalesced into shared chunks (a
#: bounded copy of glue and small leaves); larger ones stream as
#: zero-copy slices of their leaf
_COALESCE_MAX = 1 << 18


def frame_chunks(payload: Dict[str, np.ndarray], chunk_bytes: int,
                 extra: Optional[dict] = None) -> Iterator[Any]:
    """Yield the frame as buffers of at most ``chunk_bytes`` each (the
    remote tier's chunk objects): large leaves as zero-copy views cut at
    chunk boundaries, small segments (header, pads, leaves up to 256
    KiB) coalesced into shared chunks. The coalesced tensor bytes report
    to the copy meter."""
    coalesce = min(_COALESCE_MAX, chunk_bytes)
    _, segs = frame_segments(payload, extra)
    pending = bytearray()
    for seg in segs:
        is_leaf = isinstance(seg, np.ndarray)
        n = seg.nbytes if is_leaf else len(seg)
        if n <= coalesce:
            if pending and len(pending) + n > chunk_bytes:
                yield bytes(pending)
                pending = bytearray()
            pending += bytes(seg)
            if is_leaf:
                COPY_METER.add(n)
            continue
        if pending:
            yield bytes(pending)
            pending = bytearray()
        view = seg if is_leaf else memoryview(seg)
        for o in range(0, n, chunk_bytes):
            yield view[o:o + chunk_bytes]
    if pending:
        yield bytes(pending)


def save_frame_payload(path: str, payload: Dict[str, np.ndarray],
                       extra: Optional[dict] = None) -> int:
    """Atomic streamed frame write of a named-array payload."""
    return atomic_write(path, lambda f: write_frame(f, payload, extra))


def save_frame(path: str, obj: Any) -> int:
    """Atomic streamed frame write of a tree. Returns bytes written."""
    payload, extra = frame_payload(obj)
    return save_frame_payload(path, payload, extra)


def frame_dumps(obj: Any) -> bytes:
    """Frame bytes in memory (tests / byte-blob transports)."""
    payload, extra = frame_payload(obj)
    total, segs = frame_segments(payload, extra)
    out = bytearray(total)
    pos = 0
    for seg in segs:
        b = memoryview(seg).cast("B") if isinstance(seg, np.ndarray) \
            else memoryview(seg)
        out[pos:pos + len(b)] = b
        pos += len(b)
    return bytes(out)


#: test seam: callable(point: str) fired inside :func:`patch_frame` at
#: "patch:mid_span" (after the first span's pwrite when more spans
#: remain), "patch:mid_data" (after the first leaf's spans),
#: "patch:pre_header" (data fsync'd, header still old) and
#: "patch:mid_header" (half the header rewritten). Raising from the hook
#: simulates a kill at exactly that point.
_PATCH_CRASH_HOOK = None


def set_patch_crash_hook(hook) -> None:
    global _PATCH_CRASH_HOOK
    _PATCH_CRASH_HOOK = hook


def patch_frame(path: str, patch: PatchSet) -> int:
    """In-place partial rewrite of a frame file: overwrite the patched
    row ranges at ``leaf_offset + row_start * row_stride`` (the layout
    never moves), then rewrite the header with the new sha256s
    (``patch`` is a :class:`PatchSet`). Write order
    is the crash-consistency contract: span bytes are written and
    fsync'd first, each patched leaf's sha256 is recomputed (over the
    whole leaf, read back, when only some rows changed), and the header
    (same byte length: fixed-width digests) is rewritten last. A crash
    leaves torn ranges or stale digests, which is why callers journal
    each patch as a durable blob before folding it. Returns bytes
    written."""
    if not isinstance(patch, PatchSet):
        raise TypeError(f"patch_frame takes a PatchSet, not "
                        f"{type(patch).__name__}")
    hook = _PATCH_CRASH_HOOK
    magic_len = len(FRAME_MAGIC)
    with open(path, "r+b") as f:
        head = f.read(magic_len + 8)
        if len(head) < magic_len + 8 or head[:magic_len] != FRAME_MAGIC:
            raise FrameCorruptionError(
                f"{path}: not a frame (bad magic); only frame files can "
                f"be patched in place")
        (hlen,) = _struct.unpack("<Q", head[magic_len:magic_len + 8])
        try:
            header = json.loads(f.read(hlen).decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise FrameCorruptionError(f"{path}: header parse failed") from e
        pre = magic_len + 8 + hlen
        data_start = pre + (-pre) % FRAME_ALIGN
        by_name = {leaf["name"]: leaf for leaf in header["leaves"]}
        written = 0
        total_spans = patch.span_count
        spans_done = 0
        fired_span = fired_mid = False
        for name in patch:
            rec = by_name.get(name)
            if rec is None:
                raise ValueError(f"{path}: frame has no leaf {name!r}")
            rshape = tuple(rec["shape"])
            rows = rshape[0] if rshape else 1
            stride = int(rec["nbytes"]) // rows if rows else 0
            whole = patch.is_whole(name)
            if whole and list(patch.shape_of(name)) != list(rec["shape"]):
                raise ValueError(
                    f"{path}: leaf {name!r} layout mismatch "
                    f"({patch.shape_of(name)} != {tuple(rec['shape'])}); "
                    f"in-place patching never moves the frame layout")
            view = b""
            for sp in patch[name]:
                a = np.asarray(sp.data)
                span_rows = int(a.shape[0]) if a.ndim else 1
                if a.dtype.str != rec["dtype"] or (
                        (sp.start != 0 or list(a.shape) != rec["shape"])
                        and (not rshape or a.ndim == 0
                             or a.shape[1:] != rshape[1:]
                             or sp.start + span_rows > rows)):
                    raise ValueError(
                        f"{path}: leaf {name!r} layout mismatch "
                        f"(rows [{sp.start}, {sp.start + span_rows}) of "
                        f"{a.dtype.str}{a.shape} != "
                        f"{rec['dtype']}{rshape}); in-place "
                        f"patching never moves the frame layout")
                a = a if a.flags.c_contiguous else np.ascontiguousarray(a)
                view = _byte_view(a)
                f.seek(data_start + rec["offset"] + sp.start * stride)
                f.write(view)
                written += int(a.nbytes)
                spans_done += 1
                if hook is not None and not fired_span \
                        and spans_done < total_spans:
                    fired_span = True
                    f.flush()
                    os.fsync(f.fileno())
                    hook("patch:mid_span")
            if whole:
                rec["sha256"] = hashlib.sha256(view).hexdigest()
            else:
                f.flush()
                f.seek(data_start + rec["offset"])
                raw = f.read(int(rec["nbytes"]))
                rec["sha256"] = hashlib.sha256(raw).hexdigest()
            if hook is not None and not fired_mid:
                fired_mid = True
                f.flush()
                os.fsync(f.fileno())
                hook("patch:mid_data")
        f.flush()
        os.fsync(f.fileno())           # data durable before the header
        hjson = json.dumps(header).encode("utf-8")
        if len(hjson) != hlen:
            raise ValueError(f"{path}: patched header length diverged "
                             f"({len(hjson)} != {hlen}); frame is not "
                             f"patchable in place")
        if hook is not None:
            hook("patch:pre_header")
        mid = hlen // 2
        f.seek(magic_len + 8)
        f.write(hjson[:mid])
        if hook is not None:
            f.flush()
            os.fsync(f.fileno())
            hook("patch:mid_header")
        f.write(hjson[mid:])
        f.flush()
        os.fsync(f.fileno())
    return written + hlen


def _parse_frame(buf: np.ndarray, *, verify: bool,
                 source: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    magic_len = len(FRAME_MAGIC)
    if buf.nbytes < magic_len + 8 or bytes(buf[:magic_len]) != FRAME_MAGIC:
        raise FrameCorruptionError(f"{source}: not a frame (bad magic)")
    (hlen,) = _struct.unpack("<Q", bytes(buf[magic_len:magic_len + 8]))
    pre = magic_len + 8 + hlen
    if pre > buf.nbytes:
        raise FrameCorruptionError(f"{source}: truncated header")
    try:
        header = json.loads(bytes(buf[magic_len + 8:pre]).decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise FrameCorruptionError(f"{source}: header parse failed") from e
    data_start = pre + (-pre) % FRAME_ALIGN
    if data_start + header.get("data_bytes", 0) > buf.nbytes:
        raise FrameCorruptionError(f"{source}: truncated data section")
    out: Dict[str, np.ndarray] = {}
    for leaf in header["leaves"]:
        off = data_start + leaf["offset"]
        raw = buf[off:off + leaf["nbytes"]]
        if verify:
            digest = hashlib.sha256(raw).hexdigest()
            if digest != leaf["sha256"]:
                raise FrameCorruptionError(
                    f"{source}: leaf {leaf['name']!r} sha256 mismatch "
                    f"({digest[:12]} != {leaf['sha256'][:12]})")
        out[leaf["name"]] = raw.view(np.dtype(leaf["dtype"])).reshape(
            tuple(leaf["shape"]))
    return header, out


def read_frame(path: str, *, mmap: bool = True,
               verify: bool = False) -> Tuple[dict, Dict[str, np.ndarray]]:
    if mmap:
        buf = np.memmap(path, dtype=np.uint8, mode="r")
    else:
        with open(path, "rb") as f:
            buf = np.frombuffer(f.read(), dtype=np.uint8)
    return _parse_frame(buf, verify=verify, source=path)


def load_frame(path: str, *, mmap: bool = True, verify: bool = False) -> Any:
    header, leaves = read_frame(path, mmap=mmap, verify=verify)
    return unpack(header["struct"], leaves)


def frame_loads(data: bytes, *, verify: bool = False) -> Any:
    buf = np.frombuffer(data, dtype=np.uint8)
    header, leaves = _parse_frame(buf, verify=verify, source="<bytes>")
    return unpack(header["struct"], leaves)


# ----------------------------------------------------------------------
# format sniffing
# ----------------------------------------------------------------------

def is_frame_bytes(data) -> bool:
    return bytes(data[:len(FRAME_MAGIC)]) == FRAME_MAGIC


def is_frame_file(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(FRAME_MAGIC)) == FRAME_MAGIC


def load_any(path: str, *, mmap: bool = True, verify: bool = False) -> Any:
    """Load a checkpoint of either format, sniffing the magic bytes."""
    if is_frame_file(path):
        return load_frame(path, mmap=mmap, verify=verify)
    with np.load(path) as z:
        return _npz_unpack(z)


def loads_any(data: bytes, *, verify: bool = False) -> Any:
    """Deserialize a checkpoint byte blob of either format."""
    if is_frame_bytes(data):
        return frame_loads(data, verify=verify)
    return loads(bytes(data))
