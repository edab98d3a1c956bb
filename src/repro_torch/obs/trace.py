"""Span tracer: bounded ring buffer + Chrome ``trace_event`` export.

The checkpoint pipeline spreads one logical step across four threads
(main step loop, persist worker, maintenance worker, peer-replication
worker); a flat log can't show why a step stalled. This tracer records
``(name, category, tid, t_start, t_end, attrs)`` spans into a
``deque(maxlen=...)`` ring (appends are GIL-atomic; the bound makes a
week-long run safe by construction) and exports the Chrome
``trace_event`` JSON that chrome://tracing and Perfetto render as a
per-thread flame chart of the full lifecycle: step compute →
dirty-snapshot D2H → compress → persist-queue wait → backend write
(per tier) → peer fanout → fold/GC slices → replay H2D.

Cost discipline: tracing is **disabled by default** and the disabled
path is one attribute load + truthiness test returning a module-level
no-op singleton — no object allocation, no clock read. Callers
therefore sprinkle ``with trace_span(...)`` freely on the step path.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["SpanTracer", "TRACER", "trace_span", "traced"]


class _Span:
    """An open span; ``__exit__`` stamps the end time and commits the
    event tuple to the ring."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (byte counts...)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        t = self._tracer
        th = threading.current_thread()
        t._events.append((self.name, self.cat, th.ident, th.name,
                          self.t0, t1, self.attrs))
        t.events_total += 1


class _NoopSpan:
    """Shared do-nothing span for the disabled path: zero allocation,
    zero clock reads."""

    __slots__ = ()
    t0 = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class SpanTracer:
    """Ring-buffered span recorder (see module docstring)."""

    DEFAULT_BUFFER = 65536

    def __init__(self, buffer: int = DEFAULT_BUFFER, enabled: bool = False):
        self.enabled = enabled
        self.events_total = 0
        self._events: deque = deque(maxlen=buffer)

    # -- control ------------------------------------------------------
    def enable(self, buffer: Optional[int] = None) -> None:
        if buffer is not None and buffer != self._events.maxlen:
            self._events = deque(self._events, maxlen=max(1, buffer))
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._events.clear()
        self.events_total = 0

    # -- recording ----------------------------------------------------
    def span(self, name: str, cat: str = "pipeline", **attrs):
        if not self.enabled:
            return _NOOP
        return _Span(self, name, cat, attrs or None)

    # -- introspection ------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        return self.events_total - len(self._events)

    def events(self) -> List[tuple]:
        return list(self._events)

    def stats(self) -> Dict[str, Any]:
        return {"enabled": self.enabled, "buffered": len(self._events),
                "capacity": self._events.maxlen,
                "events_total": self.events_total,
                "dropped": self.dropped}

    # -- export -------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON object: one ``"X"`` (complete)
        event per span, µs timestamps, plus ``"M"`` metadata events
        naming each thread so Perfetto labels the tracks."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        threads: Dict[int, str] = {}
        for (name, cat, tid, tname, t0, t1, attrs) in list(self._events):
            threads.setdefault(tid, tname)
            ev: Dict[str, Any] = {
                "name": name, "cat": cat, "ph": "X",
                "ts": round(t0 * 1e6, 3),
                "dur": round((t1 - t0) * 1e6, 3),
                "pid": pid, "tid": tid,
            }
            if attrs:
                ev["args"] = attrs
            events.append(ev)
        for tid, tname in threads.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome(self, path: str) -> int:
        doc = self.to_chrome()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


#: process-global tracer; ``launch/train.py --trace-out`` enables it
TRACER = SpanTracer()


def trace_span(name: str, cat: str = "pipeline", **attrs):
    """``with trace_span("persist.batch", "persist", n=4):`` — records
    a span on the global tracer; a shared no-op when disabled."""
    if not TRACER.enabled:
        return _NOOP
    return _Span(TRACER, name, cat, attrs or None)


def traced(name: Optional[str] = None, cat: str = "pipeline"):
    """Decorator form: ``@traced("maint.gc", "maintenance")``."""

    def deco(fn):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not TRACER.enabled:
                return fn(*args, **kwargs)
            with _Span(TRACER, span_name, cat, None):
                return fn(*args, **kwargs)

        return wrapper

    return deco
