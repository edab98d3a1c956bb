"""Typed metrics registry: Counter / Gauge / Histogram instruments.

One currency for the telemetry every pipeline component used to
hand-roll as an ad-hoc ``stats()`` dict. Components own *per-instance*
instruments (grouped in an :class:`InstrumentSet`) so each store /
queue / meter instance keeps an independent view — the existing
``stats()`` methods become thin reads over the set — while every
instrument also registers into the process-global
:class:`MetricsRegistry`, which aggregates across live instances for
the ``--metrics-out`` dump.

Design constraints, in order:

* **Step-path cost.** ``Counter.add`` is one lock-protected float add;
  ``Histogram.observe`` is a ``bisect`` + two adds. No string
  formatting, no allocation on the hot path.
* **Backward compatibility.** Components exposed raw attributes
  (``store.bytes_written``, ``COPY_METER.bytes``) that tests and
  benchmarks read directly; those become properties over instruments,
  so the registry absorbs the counters without breaking a single
  caller.
* **No leaks.** The global registry holds weak references: a closed
  store's instruments vanish from ``collect()`` when the store is
  collected, and tests that build hundreds of stores don't accumulate.
"""
from __future__ import annotations

import bisect
import math
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "InstrumentSet",
           "MetricsRegistry", "REGISTRY", "default_buckets"]


class Counter:
    """Monotonic accumulator. ``add`` accepts negative deltas only via
    ``reset()`` — components that used ``-=`` bookkeeping (the memory
    tier's byte gauge) want a :class:`Gauge` instead."""

    __slots__ = ("name", "_value", "_lock", "__weakref__")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, delta: int | float = 1) -> None:
        with self._lock:
            self._value += delta

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    @property
    def value(self):
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "type": "counter", "value": self._value}


class Gauge:
    """Last-written value; ``add`` supports signed deltas (byte
    occupancy, queue depth)."""

    __slots__ = ("name", "_value", "_lock", "__weakref__")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def set(self, value) -> None:
        self._value = value

    def add(self, delta) -> None:
        with self._lock:
            self._value += delta

    def reset(self) -> None:
        self._value = 0

    @property
    def value(self):
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "type": "gauge", "value": self._value}


def default_buckets(lo: float = 1e-5, hi: float = 100.0,
                    per_decade: int = 4) -> List[float]:
    """Log-spaced bucket upper bounds covering [lo, hi] — the default
    spans 10µs..100s, wide enough for both a dict-insert put and a
    multi-second recovery replay at ~18% relative error."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return [lo * (hi / lo) ** (i / n) for i in range(n + 1)]


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``observe`` bisects into precomputed upper bounds; ``percentile``
    walks the cumulative counts and linearly interpolates inside the
    winning bucket (exact min/max tighten the first/last bucket), the
    standard Prometheus-style estimate — cheap, bounded memory, good
    enough for p50/p95/p99 tables."""

    __slots__ = ("name", "bounds", "_counts", "_count", "_sum",
                 "_min", "_max", "_lock", "__weakref__")

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds = list(buckets) if buckets else default_buckets()
        self._counts = [0] * (len(self.bounds) + 1)  # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def value(self) -> float:
        """Sum — lets callers treat a histogram as its total (the
        CopyMeter's ``d2h_wait_s`` style accumulators)."""
        return self._sum

    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        if not self._count:
            return 0.0
        target = self._count * min(max(p, 0.0), 100.0) / 100.0
        cum = 0
        for i, c in enumerate(self._counts):
            if not c:
                continue
            lo = self.bounds[i - 1] if i > 0 else 0.0
            hi = self.bounds[i] if i < len(self.bounds) else self._max
            # exact extremes tighten the edge buckets
            lo = max(lo, self._min) if cum == 0 else lo
            hi = min(hi, self._max)
            if cum + c >= target:
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return self._max

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "type": "histogram",
                "count": self._count, "sum": self._sum,
                "min": (None if self._count == 0 else self._min),
                "max": (None if self._count == 0 else self._max),
                "mean": self.mean(),
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Process-global instrument directory. Holds weakrefs — a
    component's instruments disappear when the component does —
    and aggregates same-named instruments across live instances on
    :meth:`collect` (multiple stores in one process sum their
    ``bytes_written``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: List[weakref.ref] = []

    def register(self, instrument):
        with self._lock:
            self._instruments.append(weakref.ref(instrument))
        return instrument

    def counter(self, name: str) -> Counter:
        return self.register(Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self.register(Gauge(name))

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self.register(Histogram(name, buckets))

    def live(self) -> List[Any]:
        with self._lock:
            alive, out = [], []
            for ref in self._instruments:
                inst = ref()
                if inst is not None:
                    alive.append(ref)
                    out.append(inst)
            self._instruments = alive
        return out

    def collect(self) -> List[Dict[str, Any]]:
        """Aggregated snapshots, one entry per instrument *name*.
        Counters/gauges sum across instances; histograms merge counts
        and report the merged percentiles via a union snapshot."""
        by_name: Dict[str, List[Any]] = {}
        for inst in self.live():
            by_name.setdefault(inst.name, []).append(inst)
        out: List[Dict[str, Any]] = []
        for name in sorted(by_name):
            insts = by_name[name]
            if len(insts) == 1:
                out.append(insts[0].snapshot())
                continue
            first = insts[0].snapshot()
            if first["type"] == "histogram":
                merged = Histogram(name, insts[0].bounds)
                for h in insts:
                    with h._lock:
                        for i, c in enumerate(h._counts):
                            if i < len(merged._counts):
                                merged._counts[i] += c
                        merged._count += h._count
                        merged._sum += h._sum
                        merged._min = min(merged._min, h._min)
                        merged._max = max(merged._max, h._max)
                out.append(merged.snapshot())
            else:
                first["value"] = sum(i.value for i in insts)
                out.append(first)
        return out


#: the process-global default registry
REGISTRY = MetricsRegistry()


class InstrumentSet:
    """A component's bundle of instruments under one name prefix.

    ``counter/gauge/histogram`` create-and-memoize by short key;
    ``view()`` returns a ``stats()``-compatible ``{key: value}`` dict
    (histograms expand to ``key`` = sum plus ``key_p50``-style keys
    only when asked). The sync test walks ``keys()`` against each
    component's ``stats()`` output to catch orphaned dict keys."""

    def __init__(self, prefix: str, registry: MetricsRegistry = REGISTRY):
        self.prefix = prefix
        self._registry = registry
        self._by_key: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _make(self, key: str, factory):
        with self._lock:
            inst = self._by_key.get(key)
            if inst is None:
                inst = factory(f"{self.prefix}.{key}")
                self._registry.register(inst)
                self._by_key[key] = inst
            return inst

    def counter(self, key: str) -> Counter:
        return self._make(key, Counter)

    def gauge(self, key: str) -> Gauge:
        return self._make(key, Gauge)

    def histogram(self, key: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._make(key, lambda n: Histogram(n, buckets))

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._by_key)

    def get(self, key: str):
        return self._by_key.get(key)

    def view(self) -> Dict[str, Any]:
        with self._lock:
            items = list(self._by_key.items())
        out: Dict[str, Any] = {}
        for key, inst in items:
            if isinstance(inst, Histogram):
                out[key] = inst.sum
            else:
                out[key] = inst.value
        return out
