"""Journaled, crash-resumable background maintenance for the
checkpoint store (port of ``repro.maintenance.service``).

Per-iteration differential checkpointing produces thousands of small
blobs per hour; metadata upkeep — garbage collection, integrity
scrubbing, journal compaction — becomes a first-order cost that must
never stall the training hot path (Check-N-Run / TierCheck both report
maintenance, not the write itself, dominating sustained checkpointing
cost at high frequency). :class:`MaintenanceService` owns one worker
thread and a set of *idempotent* tasks that checkpoint their own
progress into a :mod:`~repro_torch.maintenance.progress` journal:

* **Resumable GC** — the mark phase (``CheckpointStore.gc_plan``) runs
  under the manifest lock only and its plan is journaled; the sweep
  runs in bounded ``gc_slice``-key slices with a cursor record after
  each, so a crash at *any* boundary (after mark, between the manifest
  del and the blob delete, between slices) loses no live-chain blob and
  leaks no dead one — the restarted service finishes the sweep from
  the journaled cursor.
* **Integrity scrub** — walks cold blobs, re-verifies every frame
  leaf / remote chunk sha256 (``StorageBackend.verify``), and
  quarantines corrupt entries so recovery skips them proactively
  instead of discovering them at restore time. Completion also sweeps
  storage orphans (``CheckpointStore.sweep_orphans``, which spares
  the keys whose put is in flight).
* **Journal-segment merge** — folds multi-controller journal segments
  into the shared snapshot (``CheckpointStore.merge_journal``); the
  snapshot write is atomic and watermark-guarded, so a crash mid-merge
  re-merges idempotently.
* **Incremental merge (fold)** — folds a LowDiff+ incremental-persist
  patch chain into its base frame in place
  (``StorageBackend.patch``), ``merge_slice`` leaves per
  cursor-journaled slice, then retires the chain. The patch blobs are
  the fold's write-ahead log: they outlive the whole sweep, so a kill
  mid-pwrite, mid-header-rewrite, or at any slice boundary re-folds
  (or replays at recovery) to bit-identical bytes.

Concurrency discipline: the worker never holds the store's manifest
lock across blob I/O, task errors surface from :meth:`drain` with the
same deadline/error contract as the persist queue
(:class:`~repro_torch.core.reusing_queue.CheckpointingError`), and
``crash_hook`` is the test seam the fault-injection harness uses to
kill the worker at named task boundaries.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.remote import (RetryExhaustedError,
                                     TransientStoreError)
from repro_torch.core.reusing_queue import CheckpointingError
from repro_torch.maintenance.progress import MemoryProgress, ProgressJournal


class InjectedCrash(Exception):
    """Raised by a test crash_hook to simulate the maintenance worker
    being killed at a task boundary: the worker thread exits
    immediately, journaling nothing further — exactly what a SIGKILL
    between two journal appends leaves behind."""


class MaintenanceService:
    """Background task runtime for a :class:`~repro_torch.checkpoint.
    store.CheckpointStore`. One worker thread; tasks are queued with
    ``request_*`` (non-blocking), drained with :meth:`drain`, and
    resumed from the progress journal on :meth:`start`."""

    def __init__(self, store, *, gc_slice: int = 64, scrub_slice: int = 8,
                 merge_slice: int = 64, scrub_interval: float = 0.0,
                 orphan_min_age_s: float = 60.0,
                 drain_timeout: float = 120.0):
        self.store = store
        self.gc_slice = max(1, int(gc_slice))
        self.scrub_slice = max(1, int(scrub_slice))
        self.merge_slice = max(1, int(merge_slice))
        self.scrub_interval = scrub_interval
        self.orphan_min_age_s = orphan_min_age_s
        self.drain_timeout = drain_timeout
        root = store.backend.persist_root
        self.progress = (
            ProgressJournal(root, host=getattr(store, "host_id", None))
            if root is not None else MemoryProgress())
        self._q: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
        self._cv = threading.Condition()
        self._pending = 0            # submitted but not yet finished
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_scrub = time.monotonic()
        #: the exception that killed the worker, surfaced by drain()
        self.error: Optional[BaseException] = None
        #: test seam: callable(point:str) fired at named task
        #: boundaries; raising InjectedCrash simulates a worker kill
        self.crash_hook = None
        from repro_torch.obs.metrics import InstrumentSet
        self._inst = InstrumentSet("maintenance")
        #: stats() counter keys (the reference's)
        self.KEYS = ("gc_runs", "gc_swept", "scrub_runs", "scrubbed",
                     "scrub_transient_skips", "corrupt_found",
                     "orphans_swept", "merge_runs", "fold_runs",
                     "folded_patches", "fold_transient_skips",
                     "peer_prune_runs", "peer_pruned", "resumed")
        for k in self.KEYS:
            self._inst.counter(k)
        #: per-task worker latency, by task kind
        self._task_time = self._inst.histogram("task_time_s")

    def __getattr__(self, name):
        # legacy attribute surface: self.gc_runs etc. read counters
        if name != "KEYS" and name in getattr(self, "KEYS", ()):
            return int(self._inst.get(name).value)
        raise AttributeError(name)

    def instruments(self):
        """The backing :class:`~repro_torch.obs.metrics.InstrumentSet`."""
        return self._inst

    def _count(self, attr: str, n: int = 1):
        self._inst.counter(attr).add(n)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "MaintenanceService":
        """Start (or restart) the worker. Unfinished tasks found in the
        progress journal (a previous crash, stop, or surfaced failure)
        are enqueued first, so crash-resume needs no caller action
        beyond constructing + starting. An explicit start() clears a
        previously surfaced error: journaled work is re-attempted,
        un-journaled queued requests from the dead worker are dropped
        (they are idempotent and re-requested by their callers)."""
        if self.running:
            return self
        self._stop.clear()
        self.error = None
        with self._cv:
            self._pending = 0
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        for rec in self.progress.pending():
            self._submit(("resume", rec))
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ckpt-maintenance")
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        """Stop after the current slice. Pending planned work stays in
        the progress journal and resumes on the next start()."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=join_timeout)
        self.progress.close()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every requested task has finished — the same
        deadline/error-surfacing contract as the persist queue: a task
        failure re-raises here as CheckpointingError, and the wait is
        bounded (TimeoutError) so flush() can never hang on a dead
        worker."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.drain_timeout)
        with self._cv:
            while True:
                if self.error is not None:
                    raise CheckpointingError(
                        "maintenance worker failed; pending slices were "
                        "not applied") from self.error
                if self._pending == 0:
                    return
                if not self.running:
                    raise CheckpointingError(
                        f"maintenance worker is not running but "
                        f"{self._pending} task(s) remain pending")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"maintenance drain did not complete in time "
                        f"({self._pending} task(s) pending)")
                self._cv.wait(min(remaining, 0.05))

    # ------------------------------------------------------------------
    # requests (non-blocking; called from the training/persist threads)
    # ------------------------------------------------------------------
    def request_gc(self, retention_fulls: Optional[int] = None) -> None:
        self._submit(("gc", retention_fulls))

    def request_scrub(self) -> None:
        self._submit(("scrub", None))

    def request_merge(self) -> None:
        self._submit(("merge", None))

    def request_fold(self) -> None:
        """Fold the newest full's accumulated patch chain into its base
        frame (incremental-merging persistence) — journaled and sliced
        like GC, so a kill at any boundary resumes."""
        self._submit(("fold", None))

    def request_peer_prune(self) -> None:
        """Drop peer replicas whose keys left the live manifest (folded
        patches, GC'd chains): peer memory is a recovery accelerator,
        not an archive, so it must track the live chain. Queued
        automatically after fold and GC completions when the store's
        backend has a peer tier; a no-op otherwise. Best-effort and
        idempotent (not journaled — a missed prune is re-covered by the
        next one)."""
        self._submit(("peer_prune", None))

    def _submit(self, req: Tuple[str, Any]) -> None:
        with self._cv:
            self._pending += 1
        self._q.put(req)

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                req = self._q.get(timeout=0.05)
            except queue.Empty:
                if (self.scrub_interval > 0
                        and time.monotonic() - self._last_scrub
                        >= self.scrub_interval):
                    self._last_scrub = time.monotonic()
                    self._submit(("scrub", None))
                continue
            try:
                self._execute(req)
            except InjectedCrash:
                # simulated kill: no bookkeeping, no further journal
                # records — pending work is exactly what a real crash
                # leaves for the next start() to resume
                return
            except BaseException as e:  # noqa: B036 - surfaced by drain
                with self._cv:
                    self.error = e
                    self._pending -= 1
                    self._cv.notify_all()
                return
            with self._cv:
                self._pending -= 1
                self._cv.notify_all()

    def _crash(self, point: str) -> None:
        if self.crash_hook is not None:
            self.crash_hook(point)

    def _execute(self, req: Tuple[str, Any]) -> None:
        kind, arg = req
        from repro_torch.obs.trace import trace_span
        t0 = time.perf_counter()
        with trace_span(f"maint.{kind}", "maintenance"):
            self._dispatch(kind, arg)
        self._task_time.observe(time.perf_counter() - t0)

    def _dispatch(self, kind: str, arg: Any) -> None:
        if kind == "gc":
            self._run_gc(arg)
        elif kind == "scrub":
            self._run_scrub()
        elif kind == "merge":
            self._run_merge()
        elif kind == "fold":
            self._run_fold()
        elif kind == "peer_prune":
            self._run_peer_prune()
        elif kind == "resume":
            self._resume(arg)
        else:
            raise ValueError(f"unknown maintenance request {kind!r}")

    def _resume(self, rec: dict) -> None:
        task = rec.get("task")
        self._count("resumed")
        if task == "gc":
            self._gc_sweep(int(rec["id"]),
                           [tuple(d) for d in rec.get("doomed", [])],
                           rec.get("retention"), int(rec.get("pos", 0)))
        elif task == "scrub":
            self._scrub_sweep(int(rec["id"]),
                              [tuple(e) for e in rec.get("entries", [])],
                              int(rec.get("pos", 0)))
        elif task == "merge":
            # the merge itself is atomic + watermark-idempotent: redo it
            self._merge_step(int(rec["id"]))
        elif task == "fold":
            self._fold_sweep(int(rec["id"]), rec["base"],
                             list(rec.get("patches", [])),
                             int(rec.get("state_step", 0)),
                             int(rec.get("pos", 0)),
                             bool(rec.get("folded")))
        else:
            raise ValueError(f"unknown journaled task {task!r}")

    # ------------------------------------------------------------------
    # resumable GC: mark (journaled plan) -> sweep (journaled cursor)
    # ------------------------------------------------------------------
    def _run_gc(self, retention_fulls: Optional[int]) -> None:
        doomed = self.store.gc_plan(retention_fulls)
        if not doomed:
            return
        tid = self.progress.next_id()
        self.progress.append({"task": "gc", "id": tid, "op": "plan",
                              "retention": retention_fulls,
                              "doomed": [list(d) for d in doomed]})
        self._crash("gc:marked")
        self._gc_sweep(tid, doomed, retention_fulls, 0)

    def _gc_sweep(self, tid: int, doomed: List[Tuple[str, str]],
                  retention_fulls: Optional[int], pos: int) -> None:
        hook = ((lambda point, key: self._crash(point))
                if self.crash_hook is not None else None)
        while pos < len(doomed):
            chunk = doomed[pos:pos + self.gc_slice]
            removed = self.store.gc_apply(chunk, retention_fulls,
                                          crash_hook=hook)
            self._count("gc_swept", sum(removed.values()))
            pos += len(chunk)
            self._crash("gc:swept_slice")
            self.progress.append({"task": "gc", "id": tid,
                                  "op": "cursor", "pos": pos})
            self._crash("gc:cursored")
        self.progress.append({"task": "gc", "id": tid, "op": "done"})
        self.progress.compact_if_idle()
        self._count("gc_runs")
        self._queue_peer_prune()

    # ------------------------------------------------------------------
    # peer-replica pruning: peer memory tracks the live chain
    # ------------------------------------------------------------------
    def _queue_peer_prune(self) -> None:
        if getattr(self.store.backend, "prune_replicas", None) is not None:
            self.request_peer_prune()

    def _run_peer_prune(self) -> None:
        prune = getattr(self.store.backend, "prune_replicas", None)
        if prune is None:
            return
        # everything the live manifest still references stays; anything
        # this host replicated that fell out (folded patches, GC'd
        # chains, dropped quarantine) is deleted from the peers
        keep = {key for _, key in self.store.scrub_targets()}
        self._count("peer_pruned", int(prune(keep)))
        self._count("peer_prune_runs")

    # ------------------------------------------------------------------
    # integrity scrub: journaled walk over cold blobs
    # ------------------------------------------------------------------
    def _run_scrub(self) -> None:
        entries = self.store.scrub_targets()
        tid = self.progress.next_id()
        self.progress.append({"task": "scrub", "id": tid, "op": "plan",
                              "entries": [list(e) for e in entries]})
        self._crash("scrub:planned")
        self._scrub_sweep(tid, entries, 0)

    def _scrub_sweep(self, tid: int, entries: List[Tuple[str, str]],
                     pos: int) -> None:
        while pos < len(entries):
            for kind, key in entries[pos:pos + self.scrub_slice]:
                try:
                    reason = self.store.backend.verify(key)
                except FileNotFoundError:
                    continue  # GC'd or pruned since the plan — fine
                except (RetryExhaustedError, TransientStoreError):
                    # flaky infrastructure, not corruption: skip the
                    # blob, the next periodic scrub retries it — a
                    # transient must never poison the worker (every
                    # later flush() would fail on an intact store)
                    self._count("scrub_transient_skips")
                    continue
                self._count("scrubbed")
                if reason is not None:
                    if self.store.quarantine(kind, key, reason):
                        self._count("corrupt_found")
            pos = min(pos + self.scrub_slice, len(entries))
            self._crash("scrub:swept_slice")
            self.progress.append({"task": "scrub", "id": tid,
                                  "op": "cursor", "pos": pos})
            self._crash("scrub:cursored")
        try:
            # the store spares every key whose put runs or is not yet
            # journaled: an upload older than the age gate is no orphan
            self._count("orphans_swept", self.store.sweep_orphans(
                self.orphan_min_age_s))
        except (RetryExhaustedError, TransientStoreError):
            self._count("scrub_transient_skips")  # orphans wait for next pass
        self.progress.append({"task": "scrub", "id": tid, "op": "done"})
        self.progress.compact_if_idle()
        self._count("scrub_runs")
        self._last_scrub = time.monotonic()

    # ------------------------------------------------------------------
    # incremental merge: fold the patch chain into its base frame
    # ------------------------------------------------------------------
    def _run_fold(self) -> None:
        plan = self.store.fold_plan()
        if plan is None:
            return
        base_key, patch_keys, state_step = plan
        tid = self.progress.next_id()
        self.progress.append({"task": "fold", "id": tid, "op": "plan",
                              "base": base_key, "patches": patch_keys,
                              "state_step": state_step})
        self._crash("fold:planned")
        self._fold_sweep(tid, base_key, patch_keys, state_step, 0, False)

    def _fold_sweep(self, tid: int, base_key: str, patch_keys: List[str],
                    state_step: int, pos: int, folded: bool) -> None:
        """Sweep phase: pwrite the merged dirty leaves into the base
        frame in bounded ``merge_slice``-leaf slices, a cursor record
        after each; then mark the sweep folded and retire the chain.
        Every slice is idempotent — the patch blobs (the write-ahead
        log) outlive the whole sweep, so a kill anywhere re-folds to
        identical bytes on resume."""
        if not folded:
            try:
                updates = self.store.fold_updates(base_key, patch_keys)
            except (RetryExhaustedError, TransientStoreError):
                # flaky infrastructure, not corruption: leave the plan
                # journaled (it resumes on the next start / request)
                # — a transient must never poison the worker
                self._count("fold_transient_skips")
                return
            if updates is None:
                # chain or base gone since the plan (superseded by a
                # newer full / GC): nothing left to fold — retire
                self.progress.append({"task": "fold", "id": tid,
                                      "op": "done"})
                self.progress.compact_if_idle()
                return
            names = updates.names()
            while pos < len(names):
                chunk = updates.subset(names[pos:pos + self.merge_slice])
                try:
                    self.store.fold_slice(base_key, chunk)
                except (RetryExhaustedError, TransientStoreError):
                    self._count("fold_transient_skips")
                    return                # cursor journaled: resumes here
                except FileNotFoundError:
                    # base deleted under the fold (concurrent GC after a
                    # newer full): the chain is superseded — retire
                    self.progress.append({"task": "fold", "id": tid,
                                          "op": "done"})
                    self.progress.compact_if_idle()
                    return
                pos += len(chunk)
                self._crash("fold:patched_slice")
                self.progress.append({"task": "fold", "id": tid,
                                      "op": "cursor", "pos": pos})
                self._crash("fold:cursored")
            self.progress.append({"task": "fold", "id": tid, "op": "cursor",
                                  "pos": pos, "folded": True})
            self._crash("fold:folded")
        self.store.fold_commit(base_key, patch_keys, state_step)
        self.progress.append({"task": "fold", "id": tid, "op": "done"})
        self.progress.compact_if_idle()
        self._count("fold_runs")
        self._count("folded_patches", len(patch_keys))
        self._queue_peer_prune()

    # ------------------------------------------------------------------
    # journal-segment merge
    # ------------------------------------------------------------------
    def _run_merge(self) -> None:
        tid = self.progress.next_id()
        self.progress.append({"task": "merge", "id": tid, "op": "plan"})
        self._crash("merge:planned")
        self._merge_step(tid)

    def _merge_step(self, tid: int) -> None:
        self.store.merge_journal()
        self.progress.append({"task": "merge", "id": tid, "op": "done"})
        self.progress.compact_if_idle()
        self._count("merge_runs")

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._cv:
            pending = self._pending
        return {"running": self.running, "pending": pending,
                "gc_runs": self.gc_runs, "gc_swept": self.gc_swept,
                "scrub_runs": self.scrub_runs, "scrubbed": self.scrubbed,
                "scrub_transient_skips": self.scrub_transient_skips,
                "corrupt_found": self.corrupt_found,
                "orphans_swept": self.orphans_swept,
                "merge_runs": self.merge_runs,
                "fold_runs": self.fold_runs,
                "folded_patches": self.folded_patches,
                "fold_transient_skips": self.fold_transient_skips,
                "peer_prune_runs": self.peer_prune_runs,
                "peer_pruned": self.peer_pruned,
                "resumed": self.resumed,
                "error": repr(self.error) if self.error else None,
                "progress": self.progress.stats()}
