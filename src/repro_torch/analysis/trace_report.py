"""Render emitted observability artifacts into human-readable reports
(a copy of ``repro.analysis.trace_report``, stdlib only).

Consumes the two files a ``repro_torch.launch.train`` run emits:

* ``--trace-out trace.json`` — Chrome ``trace_event`` JSON; prints the
  top-N slowest spans and a per-category time rollup.
* ``--metrics-out metrics.jsonl`` — JSON Lines of per-step timeline
  records (``{"kind": "step", ...}``) plus the final metrics registry
  dump (``{"kind": "metric", ...}``); prints the stall-attribution
  table and the attributed fraction of checkpointed-step wall.

``--compare baseline.jsonl`` additionally reports step-path overhead
(median step wall vs. the baseline run's) — CI's <5% tracing-overhead
guard drives this.

Run::

    PYTHONPATH=src python -m repro_torch.analysis.trace_report \
        --trace /tmp/trace.json --metrics /tmp/metrics.jsonl [--top 15]
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Tuple

CATEGORIES = ("compute", "snapshot_stall", "flush_stall",
              "queue_backpressure", "recovery")


# ---------------------------------------------------------------------
# loaders (each validates the schema it claims to read)
# ---------------------------------------------------------------------
def load_chrome_trace(path: str) -> List[Dict[str, Any]]:
    """Load + validate a Chrome ``trace_event`` JSON object format
    file. Raises ``ValueError`` on schema violations so tests (and CI)
    catch a malformed exporter, not a silently empty report."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not Chrome trace_event JSON "
                         "(missing 'traceEvents')")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError(f"{path}: 'traceEvents' is not a list")
    for i, ev in enumerate(events):
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                raise ValueError(
                    f"{path}: event {i} missing required field "
                    f"{field!r}: {ev}")
        if ev["ph"] == "X" and ("ts" not in ev or "dur" not in ev):
            raise ValueError(
                f"{path}: complete event {i} missing ts/dur: {ev}")
    return events


def load_metrics_jsonl(path: str) -> Tuple[List[dict], List[dict]]:
    """Split a ``--metrics-out`` JSONL into (step records, metric
    snapshots)."""
    steps: List[dict] = []
    metrics: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if kind == "step":
                steps.append(rec)
            elif kind == "metric":
                metrics.append(rec)
    return steps, metrics


# ---------------------------------------------------------------------
# analyses
# ---------------------------------------------------------------------
def slowest_spans(events: List[dict], top: int = 15) -> List[dict]:
    spans = [ev for ev in events if ev.get("ph") == "X"]
    return sorted(spans, key=lambda ev: ev.get("dur", 0.0),
                  reverse=True)[:top]


def category_rollup(events: List[dict]) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "?")
        agg = out.setdefault(cat, {"count": 0, "total_ms": 0.0})
        agg["count"] += 1
        agg["total_ms"] += ev.get("dur", 0.0) / 1e3
    return out


def attribution(steps: List[dict]) -> Dict[str, float]:
    """Total seconds charged per category plus the attributed fraction:
    sum(categories)/sum(wall). The timeline computes compute as the
    wall residual, so the fraction is 1.0 up to float noise — the
    report asserts the *pipeline* kept it ≥95%, catching any future
    charge-accounting regression."""
    totals = {c: 0.0 for c in CATEGORIES}
    wall = 0.0
    for rec in steps:
        wall += rec.get("wall", 0.0)
        for c in CATEGORIES:
            totals[c] += rec.get(c, 0.0)
    attributed = sum(totals.values())
    totals["wall"] = wall
    totals["attributed_fraction"] = (attributed / wall) if wall else 0.0
    return totals


def median_step_wall(steps: List[dict]) -> float:
    """Median wall of in-loop step records — the step-path cost metric
    for overhead comparison (median, not mean: robust to the one-off
    flush/recovery outliers and compile-warmup first steps)."""
    walls = sorted(r["wall"] for r in steps
                   if not r.get("out_of_step") and "wall" in r)
    if not walls:
        return 0.0
    n = len(walls)
    return (walls[n // 2] if n % 2 else
            (walls[n // 2 - 1] + walls[n // 2]) / 2.0)


def overhead_pct(steps: List[dict], baseline_steps: List[dict]) -> float:
    base = median_step_wall(baseline_steps)
    cur = median_step_wall(steps)
    if base <= 0.0:
        return 0.0
    return (cur - base) / base * 100.0


# ---------------------------------------------------------------------
# report
# ---------------------------------------------------------------------
def print_stall_table(steps: List[dict], out=print) -> Dict[str, float]:
    tot = attribution(steps)
    wall = tot["wall"] or 1e-12
    out(f"stall attribution over {len(steps)} records "
        f"({tot['wall']:.3f}s wall):")
    out(f"  {'category':<20} {'seconds':>10} {'share':>8}")
    for c in CATEGORIES:
        out(f"  {c:<20} {tot[c]:>10.4f} {tot[c] / wall:>7.1%}")
    out(f"  attributed fraction: {tot['attributed_fraction']:.1%}")
    return tot


def print_span_table(events: List[dict], top: int, out=print) -> None:
    roll = category_rollup(events)
    if roll:
        out("span categories:")
        out(f"  {'category':<16} {'spans':>8} {'total_ms':>12}")
        for cat in sorted(roll, key=lambda c: -roll[c]["total_ms"]):
            agg = roll[cat]
            out(f"  {cat:<16} {agg['count']:>8d} {agg['total_ms']:>12.2f}")
    out(f"top {top} slowest spans:")
    out(f"  {'name':<28} {'cat':<14} {'ms':>10}  args")
    for ev in slowest_spans(events, top):
        args = ev.get("args") or {}
        out(f"  {ev['name']:<28} {ev.get('cat', '?'):<14} "
            f"{ev.get('dur', 0) / 1e3:>10.2f}  {args if args else ''}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="Chrome trace_event JSON from --trace-out")
    ap.add_argument("--metrics", default=None,
                    help="JSONL from --metrics-out")
    ap.add_argument("--compare", default=None, metavar="BASELINE_JSONL",
                    help="baseline --metrics-out to compute step-path "
                         "overhead %% against")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--assert-attribution", type=float, default=None,
                    metavar="FRAC", help="exit 1 unless attributed "
                    "fraction >= FRAC (CI guard)")
    ap.add_argument("--assert-overhead", type=float, default=None,
                    metavar="PCT", help="exit 1 unless --compare "
                    "overhead < PCT (CI guard)")
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics:
        ap.error("need --trace and/or --metrics")

    rc = 0
    if args.trace:
        events = load_chrome_trace(args.trace)
        print(f"{args.trace}: {len(events)} events")
        print_span_table(events, args.top)
    if args.metrics:
        steps, metrics = load_metrics_jsonl(args.metrics)
        in_loop = [r for r in steps if not r.get("out_of_step")]
        tot = print_stall_table(steps)
        print(f"median step wall: {median_step_wall(steps) * 1e3:.2f}ms "
              f"({len(in_loop)} in-loop steps)")
        if metrics:
            print(f"{len(metrics)} metric snapshots "
                  f"(pass --top to span table for details)")
        if args.assert_attribution is not None:
            frac = tot["attributed_fraction"]
            if frac < args.assert_attribution:
                print(f"FAIL: attributed fraction {frac:.3f} < "
                      f"{args.assert_attribution}")
                rc = 1
            else:
                print(f"OK: attributed fraction {frac:.3f} >= "
                      f"{args.assert_attribution}")
        if args.compare:
            base_steps, _ = load_metrics_jsonl(args.compare)
            pct = overhead_pct(steps, base_steps)
            print(f"step-path overhead vs {args.compare}: {pct:+.2f}% "
                  f"(median {median_step_wall(steps) * 1e3:.2f}ms vs "
                  f"{median_step_wall(base_steps) * 1e3:.2f}ms)")
            if args.assert_overhead is not None:
                if pct >= args.assert_overhead:
                    print(f"FAIL: overhead {pct:.2f}% >= "
                          f"{args.assert_overhead}%")
                    rc = 1
                else:
                    print(f"OK: overhead {pct:.2f}% < "
                          f"{args.assert_overhead}%")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
