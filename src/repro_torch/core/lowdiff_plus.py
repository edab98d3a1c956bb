"""LowDiff+: frequent checkpointing without gradient compression (§VI),
port of ``repro.core.lowdiff_plus``.

* **Layer-wise gradient reusing and snapshotting.** The dense step (K3)
  returns its gradient tree; each leaf is copied to pinned host memory
  with a non-blocking copy on a side stream that waits on an event
  recorded at the end of the step (:class:`~repro_torch.core.snapshot.
  PendingSnapshot`, one shard per leaf, so each leaf's device memory is
  released as its bytes land). The replica reads the pinned buffers as
  numpy views, with no further copy; the buffers go back to the pinned
  allocator only after the replica's apply of that step. At most
  ``queue_size`` steps of gradients wait in the Reusing Queue.
* **Host replica + asynchronous persistence.** A checkpointing thread
  applies each gradient to a numpy Adam replica of (params, moments) —
  an always-current in-memory checkpoint — and persists the replica
  every ``persist_interval`` steps.

``persist_mode="incremental"`` writes the first persist as a full base
and each later one as a patch of what changed (whole leaves, or row
spans with ``dirty_granularity="row"``, quantized to int8/int4 with
error feedback under ``diff_quant``); every ``fold_interval`` patches
(or when the chain reads ``fold_amplification`` times the base) the
chain is folded into the base frame.

Recovery: software failures restore from the replica; hardware failures
reload the last persisted state (``store.load_latest_state``, or
``recovery.load_state_device``, which overlays quantized patches on the
card with K7). Both return device tensors on the engine's device in the
template's dtypes.

The replica's flat keys are ``jax.tree_util.keystr`` paths (e.g.
``"['layers']['ffn']['wd']"``) in jax's sorted order, as the reference
writes them: they are frame dict keys, so both packages write the same
bytes and fold each other's chains.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.patchset import RowUpdate, mask_to_intervals
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.compression.quant_span import (DIFF_QUANTS, QUANT_METER,
                                                QuantSpan, decode_rows,
                                                encode_rows, quant_bits)
from repro_torch.core.reusing_queue import (CheckpointingError, ReusingQueue,
                                            wait_drained)
from repro_torch.core.snapshot import PendingSnapshot, host_copy
from repro_torch.core.steps import make_train_step
from repro_torch.models.param import to_tensor
from repro_torch.obs.timeline import TIMELINE
from repro_torch.obs.trace import trace_span
from repro_torch.optim.adam import AdamState


class _NumpyAdam:
    """Host-side Adam replica (elementwise numpy, the reference's verbatim).

    With ``track_dirty`` the replica records which leaves diverged from
    the last persisted snapshot; a leaf whose gradient and both moments
    are all zero is provably unchanged and skipped. ``dirty_granularity
    ="row"`` tracks axis-0 rows instead (a row changes iff its gradient
    or a pre-update moment row is nonzero), with per-row drift for the
    ``persist_threshold`` filter and clean-gap bridging of up to
    ``coalesce_rows`` rows. ``diff_quant`` ("int8"/"int4") quantizes each
    persisted row span (QuantSpan payloads) and keeps a per-row
    error-feedback residual per component: the next quantization of a
    row encodes ``value + residual``. With a threshold, a row whose
    residual exceeds it is re-marked dirty once per quantized persist."""

    GRANULARITIES = ("leaf", "row")

    def __init__(self, params, mu, nu, count, *, lr, b1=0.9, b2=0.999,
                 eps=1e-8, track_dirty: bool = False,
                 dirty_granularity: str = "leaf", coalesce_rows: int = 4,
                 diff_quant: str = "off"):
        if dirty_granularity not in self.GRANULARITIES:
            raise ValueError(f"dirty_granularity must be one of "
                             f"{self.GRANULARITIES}")
        if diff_quant not in DIFF_QUANTS:
            raise ValueError(f"diff_quant must be one of {DIFF_QUANTS}")
        self.params = {k: np.array(v, np.float32) if v.dtype != np.float32
                       else np.array(v) for k, v in params.items()}
        self.mu = {k: np.array(v) for k, v in mu.items()}
        self.nu = {k: np.array(v) for k, v in nu.items()}
        self.count = int(count)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.track_dirty = track_dirty
        self.dirty_granularity = dirty_granularity
        self.coalesce_rows = int(coalesce_rows)
        #: leaves whose replica bytes differ from the last snapshot
        self._dirty = set(self.params)
        #: accumulated L∞ parameter change since the leaf last persisted
        self._drift = {k: 0.0 for k in self.params}
        self._row_dirty: Dict[str, np.ndarray] = {}
        self._row_drift: Dict[str, np.ndarray] = {}
        self.diff_quant = diff_quant
        #: per-(component, leaf) error-feedback residuals (f32, lazily
        #: allocated on a leaf's first quantized persist)
        self._row_resid: Dict[tuple, np.ndarray] = {}
        #: rows dirty only because quantization error re-marked them
        self._row_qpending: Dict[str, np.ndarray] = {}
        if track_dirty and dirty_granularity == "row":
            for k, v in self.params.items():
                if v.ndim >= 1 and v.shape[0] > 1:
                    self._row_dirty[k] = np.ones(v.shape[0], bool)
                    self._row_drift[k] = np.zeros(v.shape[0], np.float32)
                    if diff_quant != "off":
                        self._row_qpending[k] = np.zeros(v.shape[0], bool)
        self.skipped_applies = 0

    def _resid(self, comp: str, k: str, like: np.ndarray) -> np.ndarray:
        key = (comp, k)
        r = self._row_resid.get(key)
        if r is None:
            r = np.zeros(like.shape, np.float32)
            self._row_resid[key] = r
        return r

    @staticmethod
    def _row_any(a: np.ndarray) -> np.ndarray:
        """Per-row nonzero mask (bool, shape (rows,))."""
        return a.reshape(a.shape[0], -1).any(axis=1)

    def apply(self, grads: Dict[str, np.ndarray]):
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, g in grads.items():
            g = np.asarray(g, np.float32)
            mu = self.mu[k]
            nu = self.nu[k]
            if self.track_dirty and not (g.any() or mu.any() or nu.any()):
                # zero gradient onto zero moments: the update is exactly
                # zero — the leaf provably does not change
                self.skipped_applies += 1
                continue
            rd = self._row_dirty.get(k) if self.track_dirty else None
            if rd is not None:
                changed = (self._row_any(g) | self._row_any(mu)
                           | self._row_any(nu))
            mu *= self.b1
            mu += (1 - self.b1) * g
            nu *= self.b2
            nu += (1 - self.b2) * g * g
            upd = self.lr * (mu / c1) / (np.sqrt(nu / c2) + self.eps)
            self.params[k] -= upd
            if self.track_dirty:
                self._dirty.add(k)
                if upd.size:
                    self._drift[k] += float(np.max(np.abs(upd)))
                if rd is not None:
                    rd |= changed
                    qp = self._row_qpending.get(k)
                    if qp is not None:
                        # a fresh gradient supersedes a pending
                        # quantization correction
                        qp[changed] = False
                    if upd.size:
                        rowmax = np.abs(
                            upd.reshape(upd.shape[0], -1)).max(axis=1)
                        dr = self._row_drift[k]
                        dr[changed] += rowmax[changed].astype(np.float32)

    def state(self):
        return {"params": dict(self.params), "mu": dict(self.mu),
                "nu": dict(self.nu), "count": self.count}

    # -- persistence snapshots (caller holds the replica lock) ---------
    def snapshot_full(self):
        """Copy every leaf for a full persist; all leaves become clean."""
        snap = {"params": {k: np.array(v) for k, v in self.params.items()},
                "mu": {k: np.array(v) for k, v in self.mu.items()},
                "nu": {k: np.array(v) for k, v in self.nu.items()},
                "count": np.array(self.count, np.int64)}
        if self.track_dirty:
            self._dirty.clear()
            self._drift = {k: 0.0 for k in self._drift}
            for k in self._row_dirty:
                self._row_dirty[k][:] = False
                self._row_drift[k][:] = 0.0
            # a raw full persists exact bytes: no deferred quant error
            for r in self._row_resid.values():
                r[:] = 0.0
            for qp in self._row_qpending.values():
                qp[:] = False
        return snap

    def snapshot_dirty(self, threshold: float = 0.0):
        """Copy only the dirty leaves (or, at row granularity, each dirty
        leaf's dirty row spans as RowUpdate / QuantSpan values) plus the
        Adam count. With ``threshold`` > 0 a leaf (row) whose accumulated
        relative L∞ drift is below it is deferred. Returns ``(partial
        state dict, deferred leaf count)``."""
        updates = {"params": {}, "mu": {}, "nu": {},
                   "count": np.array(self.count, np.int64)}
        deferred = 0
        for k in sorted(self._dirty):
            rd = self._row_dirty.get(k)
            if rd is None:
                if threshold > 0.0:
                    p = self.params[k]
                    scale = float(np.max(np.abs(p))) if p.size else 0.0
                    if self._drift[k] <= threshold * (scale + 1e-12):
                        deferred += 1
                        continue
                updates["params"][k] = np.array(self.params[k])
                updates["mu"][k] = np.array(self.mu[k])
                updates["nu"][k] = np.array(self.nu[k])
                self._dirty.discard(k)
                self._drift[k] = 0.0
                continue
            dr = self._row_drift[k]
            if threshold > 0.0:
                p = self.params[k]
                scale = float(np.max(np.abs(p))) if p.size else 0.0
                persist = rd & (dr > threshold * (scale + 1e-12))
            else:
                persist = rd.copy()
            if not persist.any():
                deferred += 1
                continue
            # bridge only across clean rows: a deferred dirty row must
            # not be written
            ivs = mask_to_intervals(persist, bridgeable=~rd,
                                    max_gap=self.coalesce_rows)
            rows = int(rd.shape[0])
            if self.diff_quant == "off":
                for comp, src in (("params", self.params),
                                  ("mu", self.mu), ("nu", self.nu)):
                    a = src[k]
                    if len(ivs) == 1 and ivs[0] == (0, rows):
                        updates[comp][k] = np.array(a)
                    else:
                        updates[comp][k] = RowUpdate(
                            starts=np.asarray([s for s, _ in ivs],
                                              np.int64),
                            rows=[np.array(a[s:e]) for s, e in ivs],
                            shape=tuple(a.shape))
                rd[persist] = False
                dr[persist] = 0.0
            else:
                self._snapshot_quant(k, ivs, updates)
                rd[persist] = False
                # error feedback: persisted rows carry their quantization
                # error as drift; above the threshold a row is re-marked
                # for one corrective pass
                pres = self._row_resid[("params", k)]
                qerr = np.abs(pres.reshape(rows, -1)).max(axis=1) \
                    .astype(np.float32)
                dr[persist] = qerr[persist]
                if threshold > 0.0:
                    p = self.params[k]
                    scale = float(np.max(np.abs(p))) if p.size else 0.0
                    qp = self._row_qpending[k]
                    redo = (persist & (qerr > threshold * (scale + 1e-12))
                            & ~qp)
                    qp[persist] = False
                    qp[redo] = True
                    rd[redo] = True
            if rd.any():
                self._drift[k] = float(dr[rd].max())
            else:
                self._dirty.discard(k)
                self._drift[k] = 0.0
        return updates, deferred

    def _snapshot_quant(self, k: str, ivs, updates) -> None:
        """Emit one leaf's persisting intervals as QuantSpan payloads,
        folding each component's error-feedback residual into the values
        quantized and storing the fresh residual back. The Adam moments
        floor at 8 bits under int4: the update divides mu by sqrt(nu),
        which amplifies per-row moment error at small moments."""
        pbits = quant_bits(self.diff_quant)
        t0 = time.perf_counter()
        bytes_in = bytes_out = 0
        starts = tuple(int(s) for s, _ in ivs)
        for comp, src in (("params", self.params), ("mu", self.mu),
                          ("nu", self.nu)):
            bits = pbits if comp == "params" else max(pbits, 8)
            a = src[k]
            res = self._resid(comp, k, a)
            qs, scales = [], []
            for s, e in ivs:
                corrected = a[s:e].astype(np.float32) + res[s:e]
                q, sc = encode_rows(corrected, bits)
                c2 = corrected.reshape(e - s, -1)
                deq = decode_rows(q, sc, c2.shape[1], bits)
                res[s:e] = (c2 - deq).reshape(corrected.shape)
                qs.append(q)
                scales.append(sc)
                bytes_in += int(a[s:e].nbytes)
            span = QuantSpan(starts=starts, qs=qs, scales=scales,
                             shape=tuple(a.shape), bits=bits,
                             dtype=np.dtype(a.dtype).name)
            bytes_out += span.nbytes
            updates[comp][k] = span
        QUANT_METER.add_encode(time.perf_counter() - t0, bytes_in,
                               bytes_out)

    def remark_dirty(self, updates) -> None:
        """Undo a snapshot's clean-marking after its persist failed: the
        leaves (row spans) it carried must ride the next persist.
        Infinite drift defeats any threshold."""
        for k, v in updates.get("params", {}).items():
            self._dirty.add(k)
            self._drift[k] = float("inf")
            rd = self._row_dirty.get(k)
            if rd is None:
                continue
            dr = self._row_drift[k]
            if isinstance(v, (RowUpdate, QuantSpan)):
                extents = v.extents()
            else:
                extents = [(0, rd.shape[0])]
            for s, e in extents:
                rd[s:e] = True
                dr[s:e] = np.inf
                for comp in ("params", "mu", "nu"):
                    # the residual was computed against a snapshot that
                    # never landed
                    res = self._row_resid.get((comp, k))
                    if res is not None:
                        res[s:e] = 0.0
                qp = self._row_qpending.get(k)
                if qp is not None:
                    qp[s:e] = False


def fold_due(since_fold: int, fold_interval: int, amplification: float,
             fold_amplification: float) -> bool:
    """Fold when the chain reads ``fold_amplification`` times the base
    frame, capped at ``fold_interval`` patches. ``fold_interval == 0``
    never folds; ``fold_amplification <= 0`` disables the adaptive
    trigger."""
    if not fold_interval:
        return False
    return (since_fold >= fold_interval
            or (fold_amplification > 0
                and amplification >= fold_amplification))


def _keyed_leaves(tree, prefix: str = ""):
    """(``jax.tree_util.keystr`` path, leaf) in jax's flattening order:
    dict keys sorted (``['k']``), sequences by index (``[i]``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed_leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _keyed_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _flatten(tree) -> Dict[str, Any]:
    """Path-keyed flat dict of leaves, keys as the reference writes them."""
    return dict(_keyed_leaves(tree))


def _unflatten_like(tree, flat):
    """``tree``'s structure with each leaf taken from ``flat`` by path."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(node[k], f"{prefix}[{k!r}]")
                    for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}[{i}]")
                              for i, v in enumerate(node))
        return flat[prefix]
    return build(tree, "")


def _host_f32(flat: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Host leaves as numpy (a bf16 leaf comes back from the snapshot as
    a CPU tensor: numpy has no bfloat16)."""
    return {k: v.float().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in flat.items()}


class LowDiffPlus:
    name = "lowdiff_plus"

    PERSIST_MODES = ("full", "incremental")

    def __init__(self, model, store: CheckpointStore, *, lr: float = 1e-3,
                 persist_interval: int = 1, queue_size: int = 8,
                 flush_timeout: float = 120.0,
                 persist_mode: str = "full",
                 persist_threshold: float = 0.0, fold_interval: int = 16,
                 dirty_granularity: str = "leaf",
                 fold_amplification: float = 1.5,
                 diff_quant: str = "off", device=None):
        if persist_mode not in self.PERSIST_MODES:
            raise ValueError(f"persist_mode must be one of "
                             f"{self.PERSIST_MODES}")
        if dirty_granularity not in _NumpyAdam.GRANULARITIES:
            raise ValueError(f"dirty_granularity must be one of "
                             f"{_NumpyAdam.GRANULARITIES}")
        if diff_quant not in DIFF_QUANTS:
            raise ValueError(f"diff_quant must be one of {DIFF_QUANTS}")
        if diff_quant != "off" and (persist_mode != "incremental"
                                    or dirty_granularity != "row"):
            raise ValueError(
                "--diff-quant quantizes row-span differentials: it "
                "requires --persist-mode incremental and "
                "--dirty-granularity row")
        if (persist_mode == "incremental" and store is not None
                and store.backend.fmt == "npz"):
            raise ValueError(
                "--persist-mode incremental patches checkpoint leaves "
                "in place, which requires the frame format; this store "
                "writes npz — use --format frame or --persist-mode full")
        self.model, self.store, self.lr = model, store, lr
        self.device = resolve_device(device)
        self.persist_interval = persist_interval
        self.flush_timeout = flush_timeout
        self.persist_mode = persist_mode
        self.persist_threshold = float(persist_threshold)
        #: fold the chain after this many patches (0 = never)
        self.fold_interval = int(fold_interval)
        self.dirty_granularity = dirty_granularity
        self.diff_quant = diff_quant
        self.fold_amplification = float(fold_amplification)
        self.step_fn = make_train_step(model, mode="lowdiff_plus", lr=lr)
        self.queue = ReusingQueue(maxsize=queue_size)
        self._persist_pool = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="persist")
        self._replica: Optional[_NumpyAdam] = None
        self._replica_lock = threading.Lock()
        self._consumer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # _handle appends on the consumer thread while flush() iterates
        # and clears on the caller thread
        self._pending = []
        self._pending_lock = threading.Lock()
        self._processed = 0
        self.ckpt_time = 0.0
        self.persists = 0
        self.patch_persists = 0
        self.leaves_deferred = 0
        self.adaptive_folds = 0
        self._step_counter: Optional[int] = None
        self._replica_step: Optional[int] = None
        # chain state: touched only on the consumer / persist threads
        self._base_step: Optional[int] = None
        self._since_fold = 0

    # ------------------------------------------------------------------
    def attach(self, state):
        """Initialize the host replica from the live state (a copy)."""
        self._replica = _NumpyAdam(
            _host_f32(host_copy(_flatten(state["params"]))),
            _host_f32(host_copy(_flatten(state["opt"].mu))),
            _host_f32(host_copy(_flatten(state["opt"].nu))),
            int(state["opt"].count), lr=self.lr,
            track_dirty=(self.persist_mode == "incremental"),
            dirty_granularity=self.dirty_granularity,
            diff_quant=self.diff_quant)
        self._replica_step = int(state["step"])
        self._base_step = None

    def _start_consumer(self):
        if self.queue.error is not None:
            # a lost gradient leaves the replica stale forever after
            raise CheckpointingError(
                "checkpointing consumer previously failed; the host "
                "replica is missing gradients") from self.queue.error
        if self._consumer is None or not self._consumer.is_alive():
            self._stop.clear()
            self._consumer = threading.Thread(
                target=self.queue.drain, args=(self._handle, self._stop),
                daemon=True, name="lowdiffplus-ckpt")
            self._consumer.start()

    # ------------------------------------------------------------------
    def train_step(self, state, batch):
        if self._replica is None:
            self.attach(state)
            self._step_counter = int(state["step"])
        state, metrics, grads = self.step_fn(state, batch)
        t0 = time.perf_counter()
        self._step_counter += 1
        step = self._step_counter   # host-side: never waits on the device
        self._start_consumer()
        flat = _flatten(grads)
        del grads
        # layer-wise offload: only the end-of-step event is recorded
        # here; the consumer copies leaf by leaf into pinned memory
        blocked = self.queue.put(step, PendingSnapshot(flat,
                                                       shards=len(flat)))
        TIMELINE.charge("queue_backpressure", blocked)
        self.ckpt_time += time.perf_counter() - t0
        return state, metrics

    def _handle(self, step: int, pending: PendingSnapshot):
        with trace_span("ckpt.offload", "persist", step=step):
            grads = _host_f32(pending.result())
        with self._replica_lock, \
                trace_span("replica.apply", "persist", step=step):
            self._replica.apply(grads)        # in-memory checkpoint update
            self._replica_step = step
        # the pinned buffers return to the allocator only now, after the
        # apply that read them
        del grads
        pending.release()
        if step % self.persist_interval == 0:
            # snapshot under the lock (a concurrent recover_software must
            # never see a half-copied image), submit outside it
            incremental = (self.persist_mode == "incremental"
                           and self._base_step is not None)
            with self._replica_lock:
                if incremental:
                    updates, deferred = self._replica.snapshot_dirty(
                        self.persist_threshold)
                    self.leaves_deferred += deferred
                    snap = ("patch", self._base_step, updates)
                else:
                    snap = ("full", None, self._replica.snapshot_full())
            if snap[0] == "full" and self.persist_mode == "incremental":
                self._base_step = step      # later persists chain on it
            with self._pending_lock:
                self._pending.append(
                    self._persist_pool.submit(self._persist, step, snap))
        self._processed += 1

    def _persist(self, step: int, snap):
        kind, base_step, payload = snap
        with trace_span(f"persist.{kind}", "persist", step=step):
            return self._persist_impl(step, kind, base_step, payload)

    def _persist_impl(self, step: int, kind, base_step, payload):
        if kind == "full":
            self.store.save_full(
                step, payload,
                record_names=(self.persist_mode == "incremental"))
        else:
            try:
                self.store.save_patch(step, f"full_{base_step:08d}", payload)
            except BaseException:
                # the dirty bits were cleared at snapshot time: a lost
                # patch must re-dirty its leaves or no later patch
                # carries them again
                with self._replica_lock:
                    self._replica.remark_dirty(payload)
                raise
            self.patch_persists += 1
            self._since_fold += 1
            amp = self.store.chain_amplification()
            if fold_due(self._since_fold, self.fold_interval, amp,
                        self.fold_amplification):
                if self._since_fold < self.fold_interval:
                    self.adaptive_folds += 1   # amplification fired first
                self._since_fold = 0
                self.store.request_fold()
        self.persists += 1

    def flush(self, timeout: Optional[float] = None):
        """Block until every enqueued gradient is applied to the replica
        and every scheduled persist is durable. Consumer failures
        re-raise here; the wait is deadline-bounded."""
        t = timeout if timeout is not None else self.flush_timeout
        deadline = time.monotonic() + t
        t0 = time.perf_counter()
        with trace_span("ckpt.flush", "persist"):
            wait_drained(self.queue, lambda: self._processed,
                         self._consumer, t)
            with self._pending_lock:
                pending = list(self._pending)
            for f in pending:
                f.result()              # a failure keeps the rest pending
            with self._pending_lock:
                del self._pending[:len(pending)]
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
    def _device_state(self, template_state, flat_state, step: int):
        """A training state on the engine's device: params in the
        template's dtypes, f32 moments, int32 count and step."""
        dev = self.device
        tparams = _flatten(template_state["params"])
        params = _unflatten_like(template_state["params"], {
            k: to_tensor(flat_state["params"][k], device=dev,
                         dtype=t.dtype) for k, t in tparams.items()})
        opt = template_state["opt"]
        mu = _unflatten_like(opt.mu, {
            k: to_tensor(v, device=dev, dtype=torch.float32)
            for k, v in flat_state["mu"].items()})
        nu = _unflatten_like(opt.nu, {
            k: to_tensor(v, device=dev, dtype=torch.float32)
            for k, v in flat_state["nu"].items()})
        count = torch.tensor(int(flat_state["count"]), dtype=torch.int32,
                             device=dev)
        return {"params": params, "opt": AdamState(mu, nu, count),
                "step": torch.tensor(step, dtype=torch.int32, device=dev)}

    def recover_software(self, template_state):
        """Software failure: the training process dies, the checkpointing
        thread and its host replica survive — restore from memory. The
        upload runs under the replica lock, so it sees one whole apply."""
        t_rec = time.perf_counter()
        with self._replica_lock, \
                trace_span("recovery.software", "recovery"):
            out = self._device_state(template_state, self._replica.state(),
                                     self._replica_step)
        TIMELINE.event("recovery", time.perf_counter() - t_rec,
                       step=self._step_counter)
        return out

    def recover_hardware(self, template_state):
        """Hardware failure: reload the last persisted replica — the
        latest full overlaid with its committed patch chain."""
        t_rec = time.perf_counter()
        try:
            with trace_span("recovery.hardware", "recovery"):
                blob, step = self.store.load_latest_state()
        except FileNotFoundError:
            raise FileNotFoundError("no persisted checkpoint")
        out = self._device_state(template_state, blob, step)
        TIMELINE.event("recovery", time.perf_counter() - t_rec,
                       step=self._step_counter)
        return out

    def stats(self):
        return {"queue": self.queue.stats(), "store": self.store.stats(),
                "train_loop_ckpt_time": self.ckpt_time,
                "persists": self.persists,
                "persist_mode": self.persist_mode,
                "dirty_granularity": self.dirty_granularity,
                "diff_quant": self.diff_quant,
                "quant": QUANT_METER.stats(),
                "patch_persists": self.patch_persists,
                "leaves_deferred": self.leaves_deferred,
                "fold_amplification": self.fold_amplification,
                "chain_amplification": self.store.chain_amplification(),
                "max_amplification": self.store.max_amplification,
                "adaptive_folds": self.adaptive_folds,
                "apply_leaves_skipped": (self._replica.skipped_applies
                                         if self._replica is not None
                                         else 0),
                "timeline": TIMELINE.stats()}
