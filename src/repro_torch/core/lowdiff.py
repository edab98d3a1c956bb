"""LowDiff: frequent differential checkpointing by compressed-gradient
reuse (port of ``repro.core.lowdiff``).

The training step emits the compressed gradient G̃_t; it is handed to
the Reusing Queue together with a CUDA event marking the end of step t;
a background checkpointing thread copies it to host memory (step ① of
§V-B) on a side stream that waits on that event, batches b
differentials (step ②) and persists each batch in one I/O (step ③).
The model state is checkpointed in full every ``full_interval`` steps,
asynchronously through the snapshot arena. (f, b) come from the
Eq. (10) optimum unless overridden, and the online tuner keeps
re-solving Eq. (10) from observed merge times.

Recovery: load the latest full checkpoint, then replay the differential
chain: by default as a log-depth parallel scan (``replay_parallel``,
equal to serial replay up to float reassociation), or serially / device-
staged (``replay_device``) through the same fused apply kernel the step
used (K4, K10 or K13 by compressor), which recovers the trained state
bit for bit. As in the reference, the quant8 compressor runs without
error feedback.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import recovery as rec
from repro_torch.core.config_opt import (OnlineTuner, SystemParams,
                                         practical_config)
from repro_torch.core.reusing_queue import (CheckpointingError, ReusingQueue,
                                            wait_drained)
from repro_torch.core.snapshot import (PendingSnapshot, SnapshotArena,
                                       host_copy)
from repro_torch.core.steps import make_train_step
from repro_torch.obs.timeline import TIMELINE
from repro_torch.obs.trace import trace_span


class LowDiff:
    """Checkpointing strategy object. One per training job."""

    name = "lowdiff"

    def __init__(self, model, store: CheckpointStore, *, rho: float = 0.01,
                 lr: float = 1e-3, full_interval: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 sys_params: Optional[SystemParams] = None,
                 batch_mode: str = "concat", queue_size: int = 4,
                 parallel_recovery: bool = True,
                 error_feedback: bool = True, compressor: str = "topk",
                 flush_timeout: float = 120.0,
                 replay_window: Optional[int] = None,
                 replay_device: bool = False,
                 snapshot_shards: int = 4, device=None):
        self.model, self.store = model, store
        self.device = resolve_device(device)
        self.rho, self.lr = rho, lr
        if compressor == "quant8":
            error_feedback = False
        self.batch_mode = batch_mode
        self.parallel_recovery = parallel_recovery
        self.replay_window = replay_window
        self.replay_device = replay_device
        #: >0: the full snapshot copies and lands shard by shard, each
        #: shard's device references released as its bytes land
        self.snapshot_shards = snapshot_shards
        self.flush_timeout = flush_timeout
        self.tuner = OnlineTuner(sys_params or SystemParams())
        fi, bs = practical_config(self.tuner.p)
        self._auto_full_interval = full_interval is None
        self._auto_batch_size = batch_size is None
        self.full_interval = full_interval or fi
        self.batch_size = batch_size or bs
        self.queue = ReusingQueue(maxsize=queue_size)
        self._arena = SnapshotArena(slots=2)
        self.step_fn = make_train_step(model, mode="lowdiff", rho=rho, lr=lr,
                                       error_feedback=error_feedback,
                                       compressor=compressor)
        self._buffer: List[Any] = []  # [(step, host payload)]
        self._buffer_lock = threading.Lock()
        self._persist_pool = ThreadPoolExecutor(max_workers=2,
                                                thread_name_prefix="persist")
        self._pending: List[Future] = []
        self._consumer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._step_counter: Optional[int] = None
        self._processed = 0
        self._tuning_history: "deque[Dict[str, Any]]" = deque(maxlen=256)
        self.tuning_resolves = 0
        self.tuning_applied = 0
        self.ckpt_time = 0.0
        self.full_saves = 0

    # ------------------------------------------------------------------
    # checkpointing process (background thread)
    # ------------------------------------------------------------------
    def _start_consumer(self):
        if self.queue.error is not None:
            raise CheckpointingError(
                "checkpointing consumer previously failed; differentials "
                "were lost") from self.queue.error
        if self._consumer is None or not self._consumer.is_alive():
            self._stop.clear()
            self._consumer = threading.Thread(
                target=self.queue.drain, args=(self._handle, self._stop),
                daemon=True, name="lowdiff-ckpt")
            self._consumer.start()

    def _handle(self, step: int, pending):
        """Step ①: offload to host memory (frees the device buffers)."""
        with trace_span("ckpt.offload", "persist", step=step):
            host_cg = host_copy(pending, kind="diff")
        del pending
        with self._buffer_lock:
            self._buffer.append((step, host_cg))
            full = len(self._buffer) >= self.batch_size
        if full:
            self._flush_batch()
        self._processed += 1

    def _flush_batch(self):
        with self._buffer_lock:
            if not self._buffer:
                return
            buf, self._buffer = self._buffer, []
        t0 = time.perf_counter()
        with trace_span("persist.batch", "persist", n=len(buf),
                        first=buf[0][0], last=buf[-1][0]):
            self.store.save_batch(buf[0][0], buf[-1][0],
                                  [p for _, p in buf], mode=self.batch_mode)
        merge_t = (time.perf_counter() - t0) / max(len(buf), 1)
        self.tuner.observe_merge_time(merge_t)
        # host bytes of the batch's arrays, whatever the container
        batch_bytes = sum(rec._payload_nbytes(p) for _, p in buf)
        self._apply_tuning(merge_time_s=merge_t, batch_bytes=batch_bytes)

    def _apply_tuning(self, **inputs):
        """Re-solve Eq. (10) after each batch write and apply the new
        (f, b) to the dimensions the caller left on auto."""
        stall = TIMELINE.stall_fraction()
        self.tuner.observe_stall_fraction(stall)
        interval, b = self.tuner.current()
        applied = False
        if self._auto_full_interval and interval != self.full_interval:
            self.full_interval = interval
            applied = True
        if self._auto_batch_size and b != self.batch_size:
            self.batch_size = b
            applied = True
        if applied:
            self.tuning_applied += 1
        self.tuning_resolves += 1
        self._tuning_history.append(
            {"step": self._step_counter, "full_interval": interval,
             "batch_size": b, "applied": applied,
             "stall_fraction": round(self.tuner.stall_fraction, 6),
             **{k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in inputs.items()}})

    # ------------------------------------------------------------------
    # training process hooks
    # ------------------------------------------------------------------
    def train_step(self, state, batch):
        if self._step_counter is None:
            self._step_counter = int(state["step"])   # one-time sync
        state, metrics, cg = self.step_fn(state, batch)
        t0 = time.perf_counter()
        self._step_counter += 1
        step = self._step_counter   # host-side: never waits on the device
        with trace_span("lowdiff.handoff", "step", device=True):
            self._start_consumer()
            # hand-off: the payload plus an event marking the end of step t
            blocked = self.queue.put(step, PendingSnapshot(cg))
            TIMELINE.charge("queue_backpressure", blocked)
            if step % self.full_interval == 0:
                # async snapshot: only the end-of-step event is recorded
                # here; copy, wait and write run on the persist thread,
                # overlapped with the next training steps
                pending = self._arena.snapshot_async(
                    state, shards=max(1, self.snapshot_shards))
                self._pending.append(self._persist_pool.submit(
                    self._persist_full, step, pending))
                self.full_saves += 1
        self.ckpt_time += time.perf_counter() - t0
        return state, metrics

    def _persist_full(self, step: int, pending):
        # the snapshot's host blocks are its own (fresh pinned buffers,
        # dropped by release()), so they are handed to the store: a RAM
        # tier keeps them instead of copying 1-2 GB/s into fresh pages,
        # which at a full every few seconds overlapped one full's copy
        # with the next and held both, and the snapshots' blocks, at once
        try:
            with trace_span("persist.full", "persist", step=step):
                self.store.save_full(step, pending.result(kind="full"),
                                     owned=True)
        finally:
            pending.release()

    def flush(self, timeout: Optional[float] = None):
        """Block until every queued differential/full write is durable
        and every pending maintenance task (GC, scrub, fold) has
        drained. A consumer or maintenance failure re-raises as
        CheckpointingError; the whole wait, the store's drain included,
        is bounded by ``timeout`` (default ``flush_timeout``)."""
        t = timeout if timeout is not None else self.flush_timeout
        deadline = time.monotonic() + t
        t0 = time.perf_counter()
        with trace_span("ckpt.flush", "persist"):
            wait_drained(self.queue, lambda: self._processed,
                         self._consumer, t)
            self._flush_batch()
            for f in self._pending:
                f.result()
            self._pending.clear()
            self.store.flush(timeout=max(0.0, deadline - time.monotonic()))
        TIMELINE.event("flush_stall", time.perf_counter() - t0,
                       step=self._step_counter)

    def close(self):
        try:
            self.flush()
        finally:
            self._stop.set()
            self.queue.close()
            if self._consumer is not None:
                self._consumer.join(timeout=5)
            self._persist_pool.shutdown(wait=True)
            self.store.close()

    # ------------------------------------------------------------------
    # recovery process
    # ------------------------------------------------------------------
    def recover(self):
        """Returns (state on this strategy's device, replayed_steps)."""
        t_rec = time.perf_counter()
        with trace_span("recovery.load_chain", "recovery"):
            state, diffs = rec.load_latest_chain(self.store)
        diffs = rec.contiguous_prefix(int(state["step"]), diffs)
        mode = ("device" if self.replay_device else
                "parallel" if self.parallel_recovery else "serial")
        with trace_span("recovery.replay", "recovery", device=True,
                        n=len(diffs), mode=mode):
            if self.replay_device:
                params, opt, applied = rec.replay_device(
                    state["params"], state["opt"], diffs, lr=self.lr,
                    window=self.replay_window, device=self.device)
            elif self.parallel_recovery:
                params, opt, applied = rec.replay_parallel(
                    state["params"], state["opt"], diffs, lr=self.lr,
                    window=self.replay_window, device=self.device)
            else:
                params, opt = rec.replay_serial(
                    state["params"], state["opt"], diffs, lr=self.lr,
                    device=self.device)
                applied = len(diffs)
        out = {k: rec.to_device(v, self.device) for k, v in state.items()
               if k not in ("params", "opt")}
        out["params"], out["opt"] = params, opt
        if applied:
            out["step"] = torch.tensor(diffs[applied - 1][0],
                                       dtype=torch.int32, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        TIMELINE.event("recovery", time.perf_counter() - t_rec,
                       step=self._step_counter)
        # NOTE: the error-feedback state stored in the full checkpoint is
        # stale by len(diffs) steps; exact-resume checks compare
        # params/opt (EF lives only in the training process).
        return dict(sorted(out.items())), applied

    def stats(self) -> Dict[str, Any]:
        from repro_torch.checkpoint.io import COPY_METER
        return {"queue": self.queue.stats(), "store": self.store.stats(),
                "snapshot_arena": self._arena.stats(),
                "copy_meter": COPY_METER.stats(),
                "replay_device": self.replay_device,
                "snapshot_shards": self.snapshot_shards,
                "full_interval": self.full_interval,
                "batch_size": self.batch_size,
                "tuning": {"auto": {"full_interval": self._auto_full_interval,
                                    "batch_size": self._auto_batch_size},
                           "applied": self.tuning_applied,
                           "resolves": self.tuning_resolves,
                           "history": list(self._tuning_history),
                           "params": dataclasses.asdict(self.tuner.p)},
                "train_loop_ckpt_time": self.ckpt_time,
                "full_saves": self.full_saves,
                "timeline": TIMELINE.stats()}
