"""Crash-safe progress journal for background maintenance tasks (port
of ``repro.maintenance.progress``: the same records and file names, so
a task that one package left half done resumes in the other).

Every maintenance task (resumable GC, integrity scrub, journal-segment
merge) checkpoints its own progress here as JSON-line records, so a
crash mid-task never strands blobs or re-does finished work: a
restarted service folds the log, finds the unfinished plans, and
resumes each from its last journaled cursor.

Record shapes::

    {"task": "gc",    "id": 3, "op": "plan", "doomed": [...], ...}
    {"task": "gc",    "id": 3, "op": "cursor", "pos": 128}
    {"task": "gc",    "id": 3, "op": "done"}

``plan`` carries everything needed to re-run the task from scratch,
``cursor`` advances a monotone position inside it, ``done`` retires it.
Torn tails (a crash mid-append) are tolerated exactly like the
manifest journal: the valid prefix is kept, the fragment truncated.
The log self-compacts — whenever no task is pending the file is
reset, so it stays O(active work), not O(history).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.checkpoint.journal import read_segment


class MemoryProgress:
    """Progress journal for stores with no durable root: crash-resume
    across processes is moot, but the same fold/pending API lets the
    service run unchanged over a pure-RAM tier."""

    def __init__(self):
        self.records: List[dict] = []
        self.appends = 0

    def append(self, rec: dict) -> None:
        self.records.append(dict(rec))
        self.appends += 1

    def next_id(self) -> int:
        return max((int(r.get("id", 0)) for r in self.records), default=0) + 1

    def pending(self) -> List[dict]:
        return _fold_pending(self.records)

    def compact_if_idle(self) -> None:
        if not self.pending():
            self.records = []

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        return {"appends": self.appends, "pending": len(self.pending()),
                "durable": False}


class ProgressJournal:
    """Durable task-progress journal (``<root>/maintenance.log``, or
    ``maintenance.<host>.log`` for multi-controller jobs — each host's
    service journals its own progress; sharing one file would let host
    A's idle-compaction truncate host B's in-flight plan)."""

    FILE = "maintenance.log"

    def __init__(self, root: str, host: Optional[str] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        name = f"maintenance.{host}.log" if host else self.FILE
        self.path = os.path.join(root, name)
        self.records, valid, total = read_segment(self.path)
        if valid < total:
            # drop the torn fragment so the next append starts fresh
            with open(self.path, "r+b") as f:
                f.truncate(valid)
        self._f = open(self.path, "a", encoding="utf-8")
        self.appends = 0
        self.compactions = 0

    def append(self, rec: dict) -> None:
        if self._f.closed:
            # the service was stopped and restarted: reopen for append
            self._f = open(self.path, "a", encoding="utf-8")
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self.records.append(dict(rec))
        self.appends += 1

    def next_id(self) -> int:
        return max((int(r.get("id", 0)) for r in self.records), default=0) + 1

    def pending(self) -> List[dict]:
        """Unfinished tasks: each plan record merged with its latest
        cursor position, ordered by task id."""
        return _fold_pending(self.records)

    def compact_if_idle(self) -> None:
        """Reset the log when every journaled task has retired — keeps
        the file O(active work) over an arbitrarily long run."""
        if self.pending():
            return
        self._f.close()
        self._f = open(self.path, "w", encoding="utf-8")
        self.records = []
        self.compactions += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def stats(self) -> dict:
        return {"appends": self.appends, "pending": len(self.pending()),
                "compactions": self.compactions, "durable": True}


def _fold_pending(records: List[dict]) -> List[dict]:
    plans: Dict[Tuple[str, int], dict] = {}
    for rec in records:
        k = (str(rec.get("task")), int(rec.get("id", 0)))
        op = rec.get("op")
        if op == "plan":
            merged = dict(rec)
            merged.setdefault("pos", 0)
            plans[k] = merged
        elif op == "cursor" and k in plans:
            plans[k]["pos"] = int(rec.get("pos", 0))
            if rec.get("folded"):
                # fold tasks mark sweep completion so a resume after a
                # crash mid-commit skips straight to retiring the chain
                plans[k]["folded"] = True
        elif op == "done":
            plans.pop(k, None)
    return [plans[k] for k in sorted(plans, key=lambda k: k[1])]
