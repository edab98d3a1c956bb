"""Atomic tree checkpoint serialization: the streamed frame format
(port of ``repro.checkpoint.io``, byte-compatible with it)::

    RFRAME01 | header_len u64le | JSON header | pad -> 64B | leaf buffers

The JSON header carries the structure descriptor plus one record per
leaf: byte ``offset`` (relative to the 64-byte-aligned data section),
``nbytes``, ``dtype``, ``shape`` and ``sha256``. Every leaf buffer is
64-byte aligned. Writers stream leaf by leaf; readers map the file with
``np.memmap``. The same tree written by either package gives the same
bytes, and each package reads the other's frames.

The codec covers the containers of the lowdiff path: dict, list,
tuple, NamedTuple (keyed by class name — ``AdamState``), ``SparseGrad``
(indices written as int32 under ``"__t": "sparse"``, as the reference
writes them), torch tensors, numpy arrays and python scalars. bfloat16
leaves are stored as uint16 views referenced by negative index and come
back as torch bfloat16 tensors.

Writes go through :func:`atomic_write` (temp file + fsync + rename +
parent-directory fsync), so readers never observe a torn checkpoint.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct as _struct
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compression.sparse import SparseGrad
from repro_torch.optim.adam import AdamState

FRAME_MAGIC = b"RFRAME01"
FRAME_ALIGN = 64
FORMATS = ("frame",)

_NAMEDTUPLES: Dict[str, type] = {}


def register_namedtuple(cls) -> type:
    _NAMEDTUPLES[cls.__name__] = cls
    return cls


register_namedtuple(AdamState)


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
    the parent directory. Returns bytes written."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".tmp")
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


def save_frame(path: str, obj: Any) -> int:
    """Atomic streamed frame write of a tree. Returns bytes written."""
    payload, extra = frame_payload(obj)
    return atomic_write(path, lambda f: write_frame(f, payload, extra))


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


