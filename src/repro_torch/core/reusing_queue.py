"""Reusing Queue (paper §V-A): the FIFO channel between training and
checkpointing.

JAX adaptation of the CUDA-IPC zero-copy queue: ``jax.Array`` values are
immutable, so *enqueuing the array object itself is the zero-copy hand-off*
— no process boundary and no IPC handle needed; the consumer performs the
single mandatory D2H copy (``np.asarray``) on its own thread, overlapping
the next training step (TPU D2H DMAs run concurrently with compute, and
``jax.jit`` dispatch is asynchronous, so ``put`` returns before the step
finishes).

FIFO order satisfies Requirement 1 (differentials must apply in sequence);
bounded capacity provides the backpressure that caps device-memory held by
in-flight checkpoints (the paper's Limitation 2).

Liveness: a handler exception inside :meth:`drain` is captured in
:attr:`error` instead of silently killing the consumer thread — the
producer's ``flush`` re-raises it (see :func:`wait_drained`) rather than
busy-waiting forever on a counter that will never advance. ``close`` never
blocks, even on a full queue.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional


class CheckpointingError(RuntimeError):
    """The background checkpointing consumer failed; raised from the
    producer side (``flush``) with the original handler exception as
    ``__cause__``."""


class ReusingQueue:
    #: stats() keys, synced against the instrument set by
    #: tests/test_observability.py (``consumer_error`` is derived)
    KEYS = ("enqueued", "dequeued", "put_block_time", "max_depth")

    def __init__(self, maxsize: int = 4):
        from repro_torch.obs.metrics import InstrumentSet
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._inst = InstrumentSet("queue")
        self._enqueued = self._inst.counter("enqueued")
        self._dequeued = self._inst.counter("dequeued")
        # per-put block time histogram: the registry dump gets the
        # backpressure distribution, stats() keeps the legacy sum key
        self._put_block = self._inst.histogram("put_block_time")
        self._max_depth = self._inst.gauge("max_depth")
        self._lock = threading.Lock()
        self._closed = threading.Event()
        #: the exception that killed the consumer's handler, if any
        self.error: Optional[BaseException] = None

    # legacy attribute surface (wait_drained and tests read these raw)
    @property
    def enqueued(self) -> int:
        return int(self._enqueued.value)

    @property
    def dequeued(self) -> int:
        return int(self._dequeued.value)

    @property
    def put_block_time(self) -> float:
        return self._put_block.sum

    @property
    def max_depth(self) -> int:
        return int(self._max_depth.value)

    def put(self, step: int, payload: Any) -> float:
        """Called from the training loop. Blocks only on backpressure.
        Returns the seconds this call blocked so the producer can
        charge the step's stall attribution."""
        t0 = time.perf_counter()
        self._q.put((step, payload))
        dt = time.perf_counter() - t0
        self._enqueued.add(1)
        self._put_block.observe(dt)
        with self._lock:
            if self._q.qsize() > self._max_depth.value:
                self._max_depth.set(self._q.qsize())
        return dt

    def get(self, timeout: Optional[float] = None):
        """Called from the checkpointing thread. Returns (step, payload).
        The close() sentinel is not a differential and is not counted in
        ``dequeued``."""
        item = self._q.get(timeout=timeout)
        if item[0] is not None:
            self._dequeued.add(1)
        return item

    def close(self):
        """Signal the consumer to exit once the queue is drained. Never
        blocks: on a full queue the sentinel is skipped and the closed
        flag alone stops the drain loop."""
        self._closed.set()
        try:
            self._q.put_nowait((None, None))
        except queue.Full:
            pass

    def drain(self, handler: Callable[[int, Any], None],
              stop_event: Optional[threading.Event] = None):
        """Consumer loop: call handler(step, payload) until close().
        Items already enqueued when close() lands are still handled.
        A handler exception is recorded in :attr:`error` and ends the
        loop — the producer re-raises it from flush(). A poisoned queue
        (error already set) refuses to drain: persisting differentials
        *after* a lost one would durably write a chain with a hole."""
        if self.error is not None:
            return
        while True:
            try:
                step, payload = self.get(timeout=0.2)
            except queue.Empty:
                if self._closed.is_set():
                    return
                if stop_event is not None and stop_event.is_set():
                    return
                continue
            if step is None:
                return
            try:
                handler(step, payload)
            except BaseException as e:  # noqa: B036 - must survive anything
                self.error = e
                return

    def instruments(self):
        """The backing :class:`~repro_torch.obs.metrics.InstrumentSet`."""
        return self._inst

    def stats(self):
        return {**{k: getattr(self, k) for k in self.KEYS},
                "consumer_error": repr(self.error) if self.error else None}


def wait_drained(q: ReusingQueue, processed: Callable[[], int],
                 consumer: Optional[threading.Thread], timeout: float,
                 poll_s: float = 0.005):
    """Producer-side wait until every enqueued item has been handled.

    Raises :class:`CheckpointingError` (chaining the handler exception)
    if the consumer died, and :class:`TimeoutError` when ``timeout``
    elapses — a flush must never hang forever on a counter the dead
    consumer can no longer advance.
    """
    deadline = time.monotonic() + timeout
    while processed() < q.enqueued:
        if q.error is not None:
            raise CheckpointingError(
                "checkpointing consumer failed; differentials after step "
                "of failure were not persisted") from q.error
        if consumer is None or not consumer.is_alive():
            raise CheckpointingError(
                "checkpointing consumer thread is not running but "
                f"{q.enqueued - processed()} differential(s) remain queued")
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"flush did not drain within {timeout:.1f}s "
                f"({processed()}/{q.enqueued} handled)")
        time.sleep(poll_s)
    if q.error is not None:
        raise CheckpointingError(
            "checkpointing consumer failed") from q.error
