"""Overlapped device-to-host snapshots (port of ``repro.core.snapshot``).

The reference issues ``copy_to_host_async`` on immutable jax arrays and
materializes them later on the persist thread. The port's counterpart:

1. **mark** — on the training thread, right after step t, record a CUDA
   event on the training stream (:class:`PendingSnapshot`). Nothing is
   copied yet and nothing waits.
2. **copy + materialize** — on the persist / consumer thread, a side
   copy stream waits on that event, copies each leaf with
   ``non_blocking`` into pinned host buffers, marks the source with
   ``record_stream`` (the caching allocator cannot hand its memory to a
   later step until the copy is done), and records a done event per
   shard; the thread then waits on those events — never on a
   synchronize of the training stream — and hands back host leaves.

Correctness against step t+1: the training state is replaced, never
updated in place (``core.steps``), so the tensors a snapshot references
are exactly step t's; the event orders the copy after the kernels that
produced them, and ``record_stream`` keeps their memory from being
reused while the copy runs. On the CPU the leaves are cloned.

Host leaves are numpy arrays, or CPU torch tensors for bfloat16 (numpy
has no bfloat16). :class:`SnapshotArena` bounds the snapshots in flight
(double-buffered permits), as in the reference.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import tree_leaves, tree_map
from repro_torch.checkpoint.io import COPY_METER

_COPY_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def _copy_stream(device: torch.device):
    with _streams_lock:
        s = _COPY_STREAMS.get(device.index)
        if s is None:
            s = _COPY_STREAMS[device.index] = torch.cuda.Stream(device)
        return s


def _host_leaf(h):
    if isinstance(h, torch.Tensor) and h.dtype != torch.bfloat16:
        return h.numpy()
    return h


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(getattr(x, "nbytes", 0) or 0)


def _cuda_device(leaves) -> Optional[torch.device]:
    for l in leaves:
        if isinstance(l, torch.Tensor) and l.is_cuda:
            return l.device
    return None


def _partition_leaves(nbytes: List[int], shards: int) -> List[List[int]]:
    """Split leaf positions into up to ``shards`` contiguous groups of
    roughly equal bytes."""
    if not nbytes:
        return []
    shards = max(1, min(int(shards), len(nbytes)))
    weights = nbytes if sum(nbytes) else [1] * len(nbytes)
    total = sum(weights)
    groups: List[List[int]] = [[]]
    acc = 0
    for i, w in enumerate(weights):
        if (groups[-1] and len(groups) < shards
                and acc >= total * len(groups) / shards):
            groups.append([])
        groups[-1].append(i)
        acc += w
    return groups


class PendingSnapshot:
    """A snapshot of a tree of tensors at the point of construction.

    ``result()`` (any thread) copies and materializes the host tree
    shard by shard — each shard's device references drop as soon as its
    bytes land — and caches it; ``release()`` frees the arena slot.
    ``shards=1`` is the whole-tree snapshot."""

    def __init__(self, tree, shards: int = 1,
                 arena: Optional["SnapshotArena"] = None):
        self._leaves = tree_leaves(tree)
        self._tree = tree
        self._groups = _partition_leaves([_nbytes(l) for l in self._leaves],
                                         shards)
        self._arena = arena
        self._host: Any = None
        self._done = False
        self._lock = threading.Lock()
        self._issued_at = time.perf_counter()
        self._device = _cuda_device(self._leaves)
        self._event = None
        if self._device is not None:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self._device))

    @property
    def shards(self) -> int:
        return len(self._groups)

    def _copy_cuda(self):
        stream = _copy_stream(self._device)
        host: List[Any] = list(self._leaves)
        done = []
        with torch.cuda.stream(stream):
            stream.wait_event(self._event)
            for group in self._groups:
                for i in group:
                    t = self._leaves[i]
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        h = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                        h.copy_(t, non_blocking=True)
                        t.record_stream(stream)
                        host[i] = h
                ev = torch.cuda.Event()
                ev.record(stream)
                done.append(ev)
        wait = 0.0
        for group, ev in zip(self._groups, done):
            t0 = time.perf_counter()
            ev.synchronize()
            wait += time.perf_counter() - t0
            for i in group:
                self._leaves[i] = None      # shard landed: release it
        return host, wait

    def result(self, kind: Optional[str] = None):
        """The host tree; ``kind`` ("diff" or "full") tags the
        ``snapshot.d2h`` span."""
        from repro_torch.obs.trace import trace_span
        with self._lock, trace_span("snapshot.d2h", "snapshot",
                                    shards=len(self._groups)) as sp:
            if kind is not None:
                sp.set(kind=kind)
            if self._done:
                return self._host
            if self._device is not None:
                host, wait = self._copy_cuda()
            else:
                t0 = time.perf_counter()
                host = [l.detach().clone() if isinstance(l, torch.Tensor)
                        else l for l in self._leaves]
                wait = time.perf_counter() - t0
            host = [_host_leaf(h) for h in host]
            nbytes = sum(_nbytes(h) for h in host)
            COPY_METER.add(nbytes)
            COPY_METER.add_d2h(nbytes, wait_s=wait,
                               span_s=time.perf_counter() - self._issued_at)
            sp.set(bytes=nbytes, wait_ms=round(wait * 1e3, 3))
            it = iter(host)
            self._host = tree_map(lambda _: next(it), self._tree)
            self._leaves, self._tree = [], None
            self._done = True
            return self._host

    def release(self) -> None:
        with self._lock:
            self._leaves, self._tree = [], None
            self._host = None
            self._done = True
        if self._arena is not None:
            self._arena._release()
            self._arena = None


def host_copy(tree, kind: Optional[str] = None):
    """Host copy of ``tree`` (or of a :class:`PendingSnapshot`'s tree)
    with dict keys sorted, as ``jax.tree.map`` rebuilds them — the order
    the frame writer then puts on disk. ``kind``: as in ``result``."""
    if isinstance(tree, PendingSnapshot):
        return tree.result(kind)
    return PendingSnapshot(tree).result(kind)


class SnapshotArena:
    """Double-buffered snapshot permits: at most ``slots`` snapshots in
    flight; a persist tier more than ``slots`` snapshots behind
    backpressures the training loop instead of hoarding host copies."""

    KEYS = ("snapshots", "stalls")

    def __init__(self, slots: int = 2):
        from repro_torch.obs.metrics import InstrumentSet
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.slots = slots
        self._sem = threading.Semaphore(slots)
        self._inst = InstrumentSet("snapshot_arena")
        self._snapshots = self._inst.counter("snapshots")
        self._stalls = self._inst.counter("stalls")

    @property
    def snapshots(self) -> int:
        return int(self._snapshots.value)

    @property
    def stalls(self) -> int:
        return int(self._stalls.value)

    def _acquire(self) -> float:
        stalled = 0.0
        if not self._sem.acquire(blocking=False):
            from repro_torch.obs.timeline import TIMELINE
            from repro_torch.obs.trace import trace_span
            self._stalls.add(1)
            t0 = time.perf_counter()
            with trace_span("snapshot.permit_wait", "snapshot"):
                self._sem.acquire()
            stalled = time.perf_counter() - t0
            TIMELINE.charge("snapshot_stall", stalled)
        self._snapshots.add(1)
        return stalled

    def snapshot_async(self, tree, shards: int = 1) -> PendingSnapshot:
        self._acquire()
        return PendingSnapshot(tree, shards=shards, arena=self)

    def _release(self) -> None:
        self._sem.release()

    def instruments(self):
        """The backing :class:`~repro_torch.obs.metrics.InstrumentSet`."""
        return self._inst

    def stats(self) -> Dict[str, int]:
        return {"slots": self.slots, "snapshots": self.snapshots,
                "stalls": self.stalls}
