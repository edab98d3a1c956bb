"""Sub-leaf patch currency of the persistence pipeline (port of
``repro.checkpoint.patchset``; pure numpy, the port keeps its own copy).

* :class:`Span` — one contiguous run of rows (``start`` + the row
  block). A span equal to the full leaf is the whole-leaf update.
* :class:`RowUpdate` — the serialized form of a row-sparse leaf inside a
  patch blob (a NamedTuple registered with the frame codec under the
  reference's class name, so both packages read each other's blobs).
* :class:`PatchSet` — ``frame leaf name -> ordered disjoint spans`` plus
  each leaf's full shape: what ``LocalFSBackend.patch`` takes.
* :func:`mask_to_intervals` and :func:`merge_span_chain` — dirty-mask
  to spans with clean-gap bridging, and newest-wins merging of a patch
  chain, shared by the replica tracker and the fold.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np


class Span(NamedTuple):
    """Rows ``[start, start + len(data))`` of a leaf along axis 0; a 0-d
    leaf is a single span with ``start == 0``."""

    start: int
    data: np.ndarray

    @property
    def rows(self) -> int:
        d = np.asarray(self.data)
        return int(d.shape[0]) if d.ndim else 1

    @property
    def stop(self) -> int:
        return self.start + self.rows


class RowUpdate(NamedTuple):
    """Row-sparse leaf update inside a patch blob's partial state dict:
    parallel lists of span starts and row blocks, plus the full leaf
    shape."""

    starts: np.ndarray          #: (n,) int64 span start rows
    rows: list                  #: n arrays, rows[i].shape = (len_i, *tail)
    shape: tuple                #: full leaf shape

    def spans(self) -> List[Span]:
        return [Span(int(s), np.asarray(r))
                for s, r in zip(np.asarray(self.starts).tolist(), self.rows)]

    def extents(self) -> List[List[int]]:
        return [[sp.start, sp.stop] for sp in self.spans()]

    @property
    def nbytes(self) -> int:
        return int(sum(np.asarray(r).nbytes for r in self.rows))


class PatchSet:
    """Ordered, validated ``frame leaf name -> disjoint row spans``."""

    def __init__(self) -> None:
        self._spans: Dict[str, List[Span]] = {}
        self._shapes: Dict[str, tuple] = {}

    def add(self, name: str, start: int, data,
            shape: Optional[Sequence[int]] = None) -> "PatchSet":
        """Add one span. ``shape`` is the leaf's *full* shape; omitted
        only for whole-leaf spans. Spans of one leaf must be disjoint."""
        a = np.asarray(data)
        start = int(start)
        if shape is None:
            if name in self._shapes:
                shape = self._shapes[name]
            elif start != 0:
                raise ValueError(
                    f"span for {name!r} at row {start} needs the leaf's "
                    f"full shape (only whole-leaf spans may omit it)")
            else:
                shape = a.shape
        shape = tuple(int(x) for x in shape)
        if start < 0:
            raise ValueError(f"span for {name!r}: negative start {start}")
        if shape:
            if a.shape[1:] != shape[1:]:
                raise ValueError(
                    f"span for {name!r}: tail {a.shape[1:]} != leaf tail "
                    f"{shape[1:]}")
            rows = int(a.shape[0]) if a.ndim else 1
            if start + rows > shape[0]:
                raise ValueError(
                    f"span for {name!r}: rows [{start}, {start + rows}) "
                    f"exceed leaf extent {shape[0]}")
        elif start != 0 or a.shape != ():
            raise ValueError(
                f"span for {name!r}: a scalar leaf takes exactly one "
                f"whole span")
        known = self._shapes.get(name)
        if known is not None and known != shape:
            raise ValueError(f"leaf {name!r}: conflicting full shapes "
                             f"{known} and {shape}")
        self._shapes[name] = shape
        spans = self._spans.setdefault(name, [])
        sp = Span(start, a)
        for other in spans:
            if sp.start < other.stop and other.start < sp.stop:
                raise ValueError(
                    f"leaf {name!r}: span [{sp.start}, {sp.stop}) overlaps "
                    f"[{other.start}, {other.stop})")
        spans.append(sp)
        spans.sort(key=lambda s: s.start)
        return self

    def add_spans(self, name: str, spans: Sequence[Span],
                  shape: Sequence[int]) -> "PatchSet":
        for sp in spans:
            self.add(name, sp.start, sp.data, shape)
        return self

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._spans))

    def __len__(self) -> int:
        return len(self._spans)

    def __contains__(self, name: str) -> bool:
        return name in self._spans

    def __getitem__(self, name: str) -> Tuple[Span, ...]:
        return tuple(self._spans[name])

    def names(self) -> List[str]:
        return sorted(self._spans)

    def shape_of(self, name: str) -> tuple:
        return self._shapes[name]

    def is_whole(self, name: str) -> bool:
        """True when the leaf's spans are one full-cover span."""
        spans = self._spans[name]
        shape = self._shapes[name]
        if len(spans) != 1:
            return False
        sp = spans[0]
        return sp.start == 0 and (not shape or sp.rows == shape[0])

    @property
    def nbytes(self) -> int:
        return int(sum(np.asarray(sp.data).nbytes
                       for spans in self._spans.values() for sp in spans))

    @property
    def span_count(self) -> int:
        return sum(len(s) for s in self._spans.values())

    def subset(self, names: Sequence[str]) -> "PatchSet":
        """View over a subset of leaves (span arrays shared) — the fold's
        bounded slices."""
        ps = PatchSet()
        for name in names:
            ps._spans[name] = list(self._spans[name])
            ps._shapes[name] = self._shapes[name]
        return ps

    def copy(self) -> "PatchSet":
        """Deep copy (span data owned): what a tier hands to its
        asynchronous write-back."""
        ps = PatchSet()
        for name, spans in self._spans.items():
            ps._spans[name] = [Span(sp.start, np.array(np.asarray(sp.data)))
                               for sp in spans]
            ps._shapes[name] = self._shapes[name]
        return ps

    # -- wire form -----------------------------------------------------
    def to_tree(self) -> dict:
        """Serializable tree (dicts, lists, arrays) of the peer wire
        protocol's range PATCH payload — the reference's layout, so a
        framed PATCH crosses the packages."""
        return {"__patchset__": 1,
                "leaves": {name: {
                    "shape": [int(x) for x in self._shapes[name]],
                    "starts": np.asarray(
                        [sp.start for sp in self._spans[name]], np.int64),
                    "rows": [np.asarray(sp.data)
                             for sp in self._spans[name]]}
                    for name in self}}

    @classmethod
    def is_tree(cls, obj) -> bool:
        return isinstance(obj, dict) and "__patchset__" in obj

    @classmethod
    def from_tree(cls, tree: dict) -> "PatchSet":
        ps = cls()
        for name, rec in tree["leaves"].items():
            shape = tuple(int(x) for x in rec["shape"])
            for s, r in zip(np.asarray(rec["starts"]).tolist(),
                            rec["rows"]):
                ps.add(name, int(s), np.asarray(r), shape)
        return ps


# ----------------------------------------------------------------------
# interval math
# ----------------------------------------------------------------------

def mask_to_intervals(persist: np.ndarray,
                      bridgeable: Optional[np.ndarray] = None,
                      max_gap: int = 0) -> List[Tuple[int, int]]:
    """``[start, stop)`` intervals of a boolean row mask. With ``max_gap``
    > 0 two runs separated by at most that many rows merge when every
    gap row is bridgeable (clean: re-writing it is a byte-identical
    no-op; a dirty-but-deferred row is never bridged over)."""
    idx = np.flatnonzero(persist)
    if idx.size == 0:
        return []
    out: List[Tuple[int, int]] = []
    start = prev = int(idx[0])
    for i in idx[1:].tolist():
        gap = i - prev - 1
        if gap == 0 or (gap <= max_gap and (
                bridgeable is None or bool(bridgeable[prev + 1:i].all()))):
            prev = i
            continue
        out.append((start, prev + 1))
        start = prev = i
    out.append((start, prev + 1))
    return out


def _subtract(start: int, stop: int,
              covered: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Parts of [start, stop) not covered by the sorted disjoint list."""
    out = []
    pos = start
    for s, e in covered:
        if e <= pos:
            continue
        if s >= stop:
            break
        if s > pos:
            out.append((pos, min(s, stop)))
        pos = max(pos, e)
        if pos >= stop:
            break
    if pos < stop:
        out.append((pos, stop))
    return out


def _union(covered: List[Tuple[int, int]],
           iv: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Insert one interval into a sorted disjoint list, merging."""
    s, e = iv
    out: List[Tuple[int, int]] = []
    placed = False
    for cs, ce in covered:
        if ce < s or cs > e:
            if not placed and cs > e:
                out.append((s, e))
                placed = True
            out.append((cs, ce))
        else:
            s, e = min(s, cs), max(e, ce)
    if not placed:
        out.append((s, e))
    out.sort()
    return out


def merge_span_chain(chain: Sequence[Sequence[Span]]) -> List[Span]:
    """Merge a patch chain's span lists (oldest -> newest) into one
    disjoint span list, newest wins; the emitted blocks are zero-copy
    views into the source arrays."""
    covered: List[Tuple[int, int]] = []
    out: List[Span] = []
    for spans in reversed(list(chain)):
        for sp in spans:
            d = np.asarray(sp.data)
            if d.ndim == 0:
                if not _subtract(0, 1, covered):
                    continue
                out.append(Span(0, d))
                covered = _union(covered, (0, 1))
                continue
            for s, e in _subtract(sp.start, sp.stop, covered):
                out.append(Span(s, d[s - sp.start:e - sp.start]))
            covered = _union(covered, (sp.start, sp.stop))
    out.sort(key=lambda sp: sp.start)
    return out
