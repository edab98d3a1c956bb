"""Quantized row-span differentials (port of
``repro.compression.quant_span``): the wire currency of 4/8-bit row
patches.

A :class:`QuantSpan` carries the disjoint axis-0 row intervals of one
leaf as int8 (or nibble-packed int4) values plus one f32 absmax scale
per row. The LowDiff+ replica quantizes on the host with the numpy codec
here (:func:`encode_rows` / :func:`decode_rows`, copied verbatim from the
reference); device recovery dequantizes with the ``quant_span_apply``
kernel (K7). Both perform the same f32 operations (absmax, multiply by
the pre-rounded reciprocal of qmax, IEEE divide, round half to even,
clip, cast), so host and device overlays of one payload give the same
bytes.

The reference registers :class:`QuantSpan` as a jax pytree node; the
port's tree helpers (:func:`repro_torch.tree_leaves`) treat it as one
leaf, as the store's :func:`~repro_torch.checkpoint.store.walk_leaves`
does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

DIFF_QUANTS = ("off", "int8", "int4")

_QMAX = {8: 127.0, 4: 7.0}


def quant_bits(diff_quant: str) -> int:
    """CLI value ("int8"/"int4") -> bit width."""
    return {"int8": 8, "int4": 4}[diff_quant]


# ----------------------------------------------------------------------
# pure-numpy codec — bit-identical to the span kernels (K5/K6)
# ----------------------------------------------------------------------

def encode_rows(a: np.ndarray, bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize a (n, *tail) row block with per-row absmax scales.
    Returns (q (n, wire_cols), scale (n, 1) f32); wire_cols is
    prod(tail) for int8, ceil(prod(tail)/2) for nibble-packed int4."""
    a2 = np.ascontiguousarray(np.asarray(a, np.float32)).reshape(
        a.shape[0], -1)
    n, cols = a2.shape
    qmax = np.float32(_QMAX[bits])
    if cols == 0:
        return (np.zeros((n, 0), np.int8 if bits == 8 else np.uint8),
                np.full((n, 1), 1e-12, np.float32))
    absmax = np.max(np.abs(a2), axis=1, keepdims=True)
    # multiply by the pre-rounded reciprocal instead of dividing by
    # qmax: the reference's XLA rewrites division-by-constant to
    # reciprocal-multiply, and the kernels do the same multiply
    scale = np.maximum(absmax * np.float32(1.0 / float(qmax)),
                       np.float32(1e-12)).astype(np.float32)
    qi = np.clip(np.round(a2 / scale), -qmax, qmax).astype(np.int32)
    if bits == 8:
        return qi.astype(np.int8), scale
    if cols % 2:
        qi = np.pad(qi, ((0, 0), (0, 1)))
    lo = qi[:, 0::2] & 0xF
    hi = qi[:, 1::2] & 0xF
    return (lo | (hi << 4)).astype(np.uint8), scale


def decode_rows(q: np.ndarray, scale: np.ndarray, cols: int,
                bits: int) -> np.ndarray:
    """Inverse of :func:`encode_rows` -> f32 (n, cols)."""
    n = q.shape[0]
    if cols == 0:
        return np.zeros((n, 0), np.float32)
    if bits == 8:
        g = q.astype(np.float32)
    else:
        u = q.astype(np.int32)
        lo = u & 0xF
        hi = (u >> 4) & 0xF
        lo = np.where(lo > 7, lo - 16, lo)
        hi = np.where(hi > 7, hi - 16, hi)
        g = np.empty((n, 2 * q.shape[1]), np.float32)
        g[:, 0::2] = lo
        g[:, 1::2] = hi
    return (g[:, :cols] * scale).astype(np.float32)


# ----------------------------------------------------------------------
# the container
# ----------------------------------------------------------------------

@dataclasses.dataclass
class QuantSpan:
    """Quantized row-span update for one leaf: disjoint axis-0 intervals
    carried as per-row absmax-quantized payloads.

    ``starts[i]`` is the first row of span i; ``qs[i]`` its wire bytes
    ((rows_i, wire_cols) int8 or nibble-packed uint8); ``scales[i]`` its
    (rows_i, 1) f32 per-row scales. ``shape`` is the full leaf shape,
    ``bits`` 8 or 4, ``dtype`` the leaf dtype name the dequantized rows
    are cast back to."""

    starts: Tuple[int, ...]
    qs: List[np.ndarray]
    scales: List[np.ndarray]
    shape: Tuple[int, ...]
    bits: int
    dtype: str = "float32"

    @property
    def cols(self) -> int:
        c = 1
        for d in self.shape[1:]:
            c *= int(d)
        return c

    @property
    def rows(self) -> int:
        return int(sum(q.shape[0] for q in self.qs))

    def extents(self) -> List[Tuple[int, int]]:
        """[(start, stop)) per span — same surface as RowUpdate."""
        return [(int(s), int(s) + int(q.shape[0]))
                for s, q in zip(self.starts, self.qs)]

    @property
    def nbytes(self) -> int:
        """Stored wire bytes (quantized payload + scales)."""
        return int(sum(q.nbytes + s.nbytes
                       for q, s in zip(self.qs, self.scales)))

    @property
    def logical_nbytes(self) -> int:
        """Bytes the same rows would occupy raw (the RowUpdate size)."""
        item = np.dtype(self.dtype).itemsize
        return int(self.rows * self.cols * item)

    def spans(self) -> List["Span"]:
        """Dequantized raw spans, cast to the leaf dtype — feeds the
        same newest-wins merge / overlay paths as RowUpdate.spans()."""
        from repro_torch.checkpoint.patchset import Span
        t0 = time.perf_counter()
        tail = tuple(int(d) for d in self.shape[1:])
        dt = np.dtype(self.dtype)
        out = []
        for s, q, sc in zip(self.starts, self.qs, self.scales):
            rows = decode_rows(np.asarray(q), np.asarray(sc), self.cols,
                               self.bits)
            out.append(Span(int(s),
                            rows.reshape((q.shape[0],) + tail).astype(dt)))
        QUANT_METER.add_decode(time.perf_counter() - t0)
        return out

    @classmethod
    def from_rows(cls, starts: Sequence[int], blocks: Sequence[np.ndarray],
                  shape: Tuple[int, ...], bits: int,
                  dtype: Any = None) -> "QuantSpan":
        """Quantize raw row blocks (host codec). ``blocks[i]`` holds the
        rows starting at ``starts[i]``; dtype defaults to the blocks'."""
        if dtype is None:
            dtype = blocks[0].dtype if blocks else np.float32
        qs, scales = [], []
        for b in blocks:
            q, sc = encode_rows(np.asarray(b), bits)
            qs.append(q)
            scales.append(sc)
        return cls(starts=tuple(int(s) for s in starts), qs=qs,
                   scales=scales, shape=tuple(int(d) for d in shape),
                   bits=int(bits), dtype=np.dtype(dtype).name)

    @classmethod
    def from_row_update(cls, ru, bits: int) -> "QuantSpan":
        """Quantize a :class:`~repro_torch.checkpoint.patchset.RowUpdate`
        (its spans, full shape and row dtype)."""
        spans = ru.spans()
        return cls.from_rows([sp.start for sp in spans],
                             [sp.data for sp in spans], tuple(ru.shape),
                             bits, dtype=ru.rows[0].dtype if ru.rows
                             else np.float32)


# ----------------------------------------------------------------------
# metering
# ----------------------------------------------------------------------

class QuantMeter:
    """Process-wide quantized-differential codec meter: encode/decode
    wall time plus logical-in vs stored-out byte counters (the realized
    compression ratio of the quantized patch stream)."""

    KEYS = ("encode_s", "decode_s", "bytes_in", "bytes_out")

    def __init__(self):
        from repro_torch.obs.metrics import InstrumentSet
        self._inst = InstrumentSet("quant")
        self._encode = self._inst.histogram("encode_s")
        self._decode = self._inst.histogram("decode_s")
        self._bytes_in = self._inst.counter("bytes_in")
        self._bytes_out = self._inst.counter("bytes_out")

    @property
    def encode_s(self) -> float:
        return self._encode.sum

    @property
    def decode_s(self) -> float:
        return self._decode.sum

    @property
    def bytes_in(self) -> int:
        return int(self._bytes_in.value)

    @property
    def bytes_out(self) -> int:
        return int(self._bytes_out.value)

    def add_encode(self, seconds: float, bytes_in: int,
                   bytes_out: int) -> None:
        self._encode.observe(float(seconds))
        self._bytes_in.add(int(bytes_in))
        self._bytes_out.add(int(bytes_out))

    def add_decode(self, seconds: float) -> None:
        self._decode.observe(float(seconds))

    def ratio(self):
        """Logical bytes per stored byte (None until an encode ran)."""
        if self.bytes_out <= 0:
            return None
        return self.bytes_in / self.bytes_out

    def instruments(self):
        """The backing :class:`~repro_torch.obs.metrics.InstrumentSet`."""
        return self._inst

    def stats(self) -> Dict[str, Any]:
        out = {k: getattr(self, k) for k in self.KEYS}
        out["ratio"] = self.ratio()
        return out

    def reset(self) -> None:
        self._encode.reset()
        self._decode.reset()
        self._bytes_in.reset()
        self._bytes_out.reset()


QUANT_METER = QuantMeter()
