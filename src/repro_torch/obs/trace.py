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

Two views beyond the host clock, both on the enabled path only:

* **The card's clock.** ``trace_span(..., device=True)`` also records a
  timing CUDA event on the current stream at entry and at exit. The
  first such span takes an anchor (synchronize, record an event, read
  ``perf_counter``) that maps event times onto ``perf_counter``; once
  its events complete, the span's attributes carry ``dev_t0`` and
  ``dev_t1`` in seconds on the clock of ``t0``/``t1``. Pending events
  are resolved as they complete and by :meth:`SpanTracer.events`, so
  the ring holds floats, never live events. Nothing happens in a
  process that has not initialised CUDA. One device per process.
* **torch.profiler.** While a profiler session records, every span
  also enters ``torch.profiler.record_function(name)``, so program
  phases show in its trace as ``user_annotation`` /
  ``gpu_user_annotation`` over the kernels they launched.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["SpanTracer", "TRACER", "trace_span", "traced"]

_profiling = torch.autograd._profiler_enabled


class CudaClock:
    """The card's clock as the tracer reads it: timing events recorded
    on the current stream. Tests inject a stand-in with these methods."""

    @staticmethod
    def ready() -> bool:
        return torch.cuda.is_initialized()

    @staticmethod
    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def synchronize() -> None:
        torch.cuda.synchronize()

    @staticmethod
    def done(ev) -> bool:
        return ev.query()

    @staticmethod
    def wait(ev) -> None:
        ev.synchronize()

    @staticmethod
    def seconds(a, b) -> float:
        """Card seconds from event ``a`` to event ``b``."""
        return a.elapsed_time(b) * 1e-3


class _Span:
    """An open span; ``__exit__`` stamps the end time and commits the
    event tuple to the ring."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "t0", "_device",
                 "_ev0", "_rf")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 attrs: Optional[Dict[str, Any]], device: bool = False):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.t0 = 0.0
        self._device = device
        self._ev0 = None
        self._rf = None

    def __enter__(self) -> "_Span":
        if _profiling():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        if self._device:
            self._ev0 = self._tracer._device_mark()
        self.t0 = self._tracer.clock()
        return self

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (byte counts...)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __exit__(self, *exc) -> None:
        t = self._tracer
        t1 = t.clock()
        if self._ev0 is not None:
            if self.attrs is None:
                self.attrs = {}
            t._device_close(self.attrs, self._ev0)
        if self._rf is not None:
            self._rf.__exit__(*exc)
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
    """Ring-buffered span recorder (see module docstring). ``clock`` is
    the host clock of ``t0``/``t1``, ``device_clock`` the card's
    (:class:`CudaClock`)."""

    DEFAULT_BUFFER = 65536
    ANCHOR_READS = 3

    def __init__(self, buffer: int = DEFAULT_BUFFER, enabled: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 device_clock=CudaClock):
        self.enabled = enabled
        self.events_total = 0
        self._events: deque = deque(maxlen=buffer)
        self.clock = clock
        self.device_clock = device_clock
        #: (anchor event, its time on ``clock``), taken at the first
        #: device span after a clear
        self._anchor: Optional[Tuple[Any, float]] = None
        #: [(attrs, entry event, exit event)] of device spans not yet
        #: resolved, oldest first
        self._pending: deque = deque()
        self._lock = threading.Lock()

    # -- control ------------------------------------------------------
    def enable(self, buffer: Optional[int] = None) -> None:
        if buffer is not None and buffer != self._events.maxlen:
            self._events = deque(self._events, maxlen=max(1, buffer))
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._pending.clear()
            self._anchor = None
        self.events_total = 0

    # -- recording ----------------------------------------------------
    def span(self, name: str, cat: str = "pipeline", device: bool = False,
             **attrs):
        if not self.enabled:
            return _NOOP
        return _Span(self, name, cat, attrs or None, device)

    # -- the card's clock ----------------------------------------------
    def _take_anchor(self) -> Tuple[Any, float]:
        """An event on an idle card and its time on ``clock``: the
        middle of the interval in which the card recorded it, from the
        narrowest of ``ANCHOR_READS`` reads (another thread holding the
        interpreter lock widens a read)."""
        dc = self.device_clock
        dc.synchronize()
        best = None
        for _ in range(self.ANCHOR_READS):
            h0 = self.clock()
            ev = dc.mark()
            dc.wait(ev)
            h1 = self.clock()
            if best is None or h1 - h0 < best[0]:
                best = (h1 - h0, ev, (h0 + h1) / 2)
        return best[1], best[2]

    def _device_mark(self):
        dc = self.device_clock
        if not dc.ready():
            return None
        if self._anchor is None:
            with self._lock:
                if self._anchor is None:
                    self._anchor = self._take_anchor()
        return dc.mark()

    def _device_close(self, attrs: Dict[str, Any], ev0) -> None:
        self._pending.append((attrs, ev0, self.device_clock.mark()))
        self._resolve(block=False)

    def _resolve(self, block: bool) -> None:
        """Write ``dev_t0``/``dev_t1`` into the attributes of pending
        device spans, oldest first: those complete (all of them, waiting,
        with ``block``)."""
        dc = self.device_clock
        with self._lock:
            if self._anchor is None:       # cleared while a span was open
                self._pending.clear()
            while self._pending:
                attrs, ev0, ev1 = self._pending[0]
                if block:
                    dc.wait(ev1)
                elif not dc.done(ev1):
                    return
                anchor, at = self._anchor
                attrs["dev_t0"] = at + dc.seconds(anchor, ev0)
                attrs["dev_t1"] = at + dc.seconds(anchor, ev1)
                self._pending.popleft()

    def clock_error(self) -> Optional[float]:
        """Seconds by which the anchor's mapping misplaces a fresh
        anchor (mapped minus read), or None before the first device
        span. Synchronizes the card."""
        if self._anchor is None:
            return None
        ev, at = self._take_anchor()
        anchor, at0 = self._anchor
        return at0 + self.device_clock.seconds(anchor, ev) - at

    # -- introspection ------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        return self.events_total - len(self._events)

    def events(self) -> List[tuple]:
        """The ring's spans, oldest first; waits for the card to finish
        every device span still pending and resolves it."""
        self._resolve(block=True)
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
        naming each thread so Perfetto labels the tracks. A device
        span's interval on the card is a second ``"X"`` event on the
        track ``tid`` "device"."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        threads: Dict[Any, str] = {}
        for (name, cat, tid, tname, t0, t1, attrs) in self.events():
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
            if attrs and "dev_t0" in attrs:
                threads.setdefault("device", "device")
                d0, d1 = attrs["dev_t0"], attrs["dev_t1"]
                events.append({"name": name, "cat": cat, "ph": "X",
                               "ts": round(d0 * 1e6, 3),
                               "dur": round((d1 - d0) * 1e6, 3),
                               "pid": pid, "tid": "device"})
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


def trace_span(name: str, cat: str = "pipeline", device: bool = False,
               **attrs):
    """``with trace_span("persist.batch", "persist", n=4):`` — records
    a span on the global tracer; a shared no-op when disabled.
    ``device=True`` also times the span on the card (module docstring)."""
    if not TRACER.enabled:
        return _NOOP
    return _Span(TRACER, name, cat, attrs or None, device)


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
