"""Per-step stall attribution: where did each step's wall time go?

The paper's claim is a *time* claim — checkpointing hidden behind
compute — so the first-class question is "what fraction of a step was
stall?". :class:`StepTimeline` charges each step's wall time to the
categories

* ``compute`` — the residual: wall minus every attributed stall
* ``snapshot_stall`` — blocked waiting for a snapshot arena permit or
  a synchronous D2H copy on the step path
* ``flush_stall`` — blocked in ``flush()`` draining the persist queue
  (failure injection, shutdown, barrier-style persists)
* ``queue_backpressure`` — blocked in ``ReusingQueue.put`` because the
  consumer fell behind
* ``recovery`` — restoring state after a failure

The driver owns step boundaries (``begin``/``commit``); strategies
charge stalls from wherever they block (``charge`` is thread-safe —
the persist consumer never charges, only the step thread blocks, but
the API doesn't assume it). Work that happens *outside* a step window
(a flush after the loop, recovery between steps) is recorded with
:meth:`event` so attribution still sums to observed wall.

The tuner consumes :meth:`stall_fraction` — stalls over wall across a
recent window — a cleaner signal than raw wall-clock, which conflates
checkpoint cost with compute jitter.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["StepTimeline", "TIMELINE", "STALL_CATEGORIES"]

STALL_CATEGORIES = ("snapshot_stall", "flush_stall", "queue_backpressure",
                    "recovery")
CATEGORIES = ("compute",) + STALL_CATEGORIES


class StepTimeline:
    """Bounded per-step ledger of wall-time attribution."""

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=maxlen)
        self._open_step: Optional[int] = None
        self._charges: Dict[str, float] = {}
        self.steps_total = 0

    # -- step window --------------------------------------------------
    def begin(self, step: int) -> None:
        with self._lock:
            self._open_step = step
            self._charges = {}

    def charge(self, category: str, seconds: float) -> None:
        """Attribute ``seconds`` of the open step to ``category``.
        Charges landing outside a step window (consumer-thread stalls
        after commit) are dropped — they are not step-path time."""
        if seconds <= 0.0:
            return
        with self._lock:
            if self._open_step is None:
                return
            self._charges[category] = (
                self._charges.get(category, 0.0) + seconds)

    def commit(self, step: int, wall: float) -> Dict[str, float]:
        """Close the step window: compute = wall − attributed stalls
        (clamped at 0 — a stall measured longer than the wall, e.g.
        clock skew across charge sites, never goes negative)."""
        with self._lock:
            charges = self._charges
            self._open_step = None
            self._charges = {}
            stalls = sum(charges.values())
            rec = {"step": step, "wall": wall,
                   "compute": max(0.0, wall - stalls)}
            for cat in STALL_CATEGORIES:
                if cat in charges:
                    rec[cat] = charges[cat]
            self._records.append(rec)
            self.steps_total += 1
            return rec

    def event(self, category: str, seconds: float,
              step: Optional[int] = None) -> None:
        """Record out-of-step work (post-loop flush, recovery) as its
        own zero-compute record so totals still match observed wall."""
        if seconds <= 0.0:
            return
        with self._lock:
            if self._open_step is not None:
                # inside a step window: charge it there instead
                self._charges[category] = (
                    self._charges.get(category, 0.0) + seconds)
                return
            self._records.append({"step": step, "wall": seconds,
                                  "compute": 0.0, category: seconds,
                                  "out_of_step": True})

    # -- consumption --------------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def stall_fraction(self, window: int = 32) -> float:
        """Stalled seconds over wall seconds across the last ``window``
        step records (out-of-step events excluded: the tuner wants the
        steady-state step-path signal, not one-off recovery cost)."""
        with self._lock:
            recs = [r for r in self._records
                    if not r.get("out_of_step")][-window:]
        wall = sum(r["wall"] for r in recs)
        if wall <= 0.0:
            return 0.0
        stall = sum(sum(r.get(c, 0.0) for c in STALL_CATEGORIES)
                    for r in recs)
        return min(1.0, stall / wall)

    def totals(self) -> Dict[str, float]:
        out = {c: 0.0 for c in CATEGORIES}
        out["wall"] = 0.0
        for r in self.records():
            out["wall"] += r["wall"]
            for c in CATEGORIES:
                out[c] += r.get(c, 0.0)
        return out

    def stats(self) -> Dict[str, Any]:
        t = self.totals()
        return {"steps": self.steps_total,
                "stall_fraction": self.stall_fraction(),
                **{k: round(v, 6) for k, v in t.items()}}

    def write_jsonl(self, path: str, extra: Optional[List[dict]] = None,
                    mode: str = "w") -> int:
        """Dump step records (+ optional tagged extras, e.g. the final
        metrics registry collection) as JSON Lines."""
        n = 0
        with open(path, mode, encoding="utf-8") as f:
            for rec in self.records():
                f.write(json.dumps({"kind": "step", **rec}) + "\n")
                n += 1
            for rec in (extra or []):
                f.write(json.dumps(rec) + "\n")
                n += 1
        return n

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._open_step = None
            self._charges = {}
            self.steps_total = 0


#: process-global timeline — strategies charge it, the driver frames it
TIMELINE = StepTimeline()
