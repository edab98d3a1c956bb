"""Unified checkpoint-pipeline observability.

Three layers over one currency:

* :mod:`repro_torch.obs.metrics` — typed Counter/Gauge/Histogram instruments
  + the process-global :data:`~repro_torch.obs.metrics.REGISTRY`; components
  register per-instance :class:`~repro_torch.obs.metrics.InstrumentSet`\\ s
  and their legacy ``stats()`` dicts become thin views.
* :mod:`repro_torch.obs.trace` — bounded ring-buffer span tracer
  (:data:`~repro_torch.obs.trace.TRACER`, ``with trace_span(...)``,
  ``@traced``) with a Chrome ``trace_event`` exporter for
  chrome://tracing / Perfetto.
* :mod:`repro_torch.obs.timeline` — :class:`~repro_torch.obs.timeline.StepTimeline`
  charging each step's wall to {compute, snapshot-stall, flush-stall,
  queue-backpressure, recovery}; feeds the online (f, b) tuner a
  stall-fraction signal.

``launch/train.py --trace-out/--metrics-out/--trace-buffer`` emit the
artifacts.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, InstrumentSet,
                               MetricsRegistry, REGISTRY)
from repro_torch.obs.timeline import STALL_CATEGORIES, StepTimeline, TIMELINE
from repro_torch.obs.trace import SpanTracer, TRACER, trace_span, traced

__all__ = ["Counter", "Gauge", "Histogram", "InstrumentSet",
           "MetricsRegistry", "REGISTRY", "SpanTracer", "TRACER",
           "trace_span", "traced", "StepTimeline", "TIMELINE",
           "STALL_CATEGORIES"]
