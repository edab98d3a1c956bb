"""The benchmark's runner: finds a cell's files by name, runs its driver,
reads the per-layer metrics, judges ``correct`` and prints the result.

Everything that belongs to one cell is data or a file of its own:

* ``BENCHMARK.json`` names the cell, its configuration and its traffic;
* ``chipbench/configs/<config>.json``: the sizes as run (``file``);
  its ``family`` selects the reference's layer, weight layout, counts
  and program keys, ``chipbench/reference/families/<family>.py``;
* ``chipbench/traffic/<traffic>.json``: the traffic's parameters; its
  ``kind`` selects the driver ``chipbench/drivers/<kind>.py``;
* ``chipbench/layer_metrics/<metric>.py``: one reader per per-layer
  metric, ``read(run) -> float or None``;
* ``chipbench/limits/<workload>.json``: the limits of its comparisons.

A driver's ``run(cell, device, seed, seconds, trace)`` returns a
:class:`Run`. :func:`run_cell` is also the test hook: it takes any
device, so the tests drive a cell on the CPU at a tiny size, while the
command itself (:func:`main`) refuses to run without a card.
"""
from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from chipbench import compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names the window must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux)."""
    with open("/proc/self/stat", encoding="ascii") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime", encoding="ascii") as f:
        uptime = float(f.read().split()[0])
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - age


@dataclass
class Cell:
    root: str
    workload: dict
    model: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    model = _json(os.path.join(root, conf["file"]))
    model["family_file"] = os.path.join(root, "chipbench", "reference",
                                        "families", f"{model['family']}.py")
    traffic = _json(os.path.join(root, "chipbench", "traffic",
                                 f"{wl['traffic']}.json"))
    return Cell(root, wl, model, traffic,
                compare.load_limits(root, name))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    kind = cell.traffic["kind"]
    return _load(os.path.join(cell.root, "chipbench", "drivers",
                              f"{kind}.py"), f"chipbench_driver_{kind}")


@dataclass
class Run:
    """What a driver hands back: its end-to-end metrics, what the readers
    read, and the numbers compared."""
    kind: str
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: Dict[str, float]
    model: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    #: the window's steps or recoveries
    units: int = 0
    #: TRACER spans that ended in the window: (name, t0, t1, attrs)
    spans: List[tuple] = field(default_factory=list)
    #: TIMELINE step records of the window
    timeline: List[dict] = field(default_factory=list)
    #: the profiled stretch after the window (``profile`` below)
    profile: Optional[dict] = None
    extra: Dict[str, Any] = field(default_factory=dict)


def per_layer_metrics(bench: dict, cell: Cell) -> List[dict]:
    """The per-layer metrics this cell reports."""
    mine = {m["name"] for m in bench["end_to_end"]
            if cell.name in m.get("workloads", [cell.name])}
    return [m for m in bench["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def read_layers(bench: dict, cell: Cell, run: Run) -> Dict[str, dict]:
    out = {}
    for m in per_layer_metrics(bench, cell):
        path = os.path.join(cell.root, "chipbench", "layer_metrics",
                            f"{m['name']}.py")
        value = _load(path, "chipbench_metric_" + m["name"].replace(
            ".", "_")).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def e2e_metrics(bench: dict, cell: Cell, run: Run) -> Dict[str, dict]:
    out = {}
    for m in bench["end_to_end"]:
        if cell.name in m.get("workloads", [cell.name]):
            out[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    return out


# ------------------------------------------------------------ profiling
def profiled(fn: Callable[[], Any], device) -> dict:
    """Run ``fn`` under ``torch.profiler`` (the card's kernels through
    CUPTI), the trace written under ``$TMPDIR`` and read back. Returns
    {"kernel_s": {kernel: seconds}, "busy_s", "window_s", "device_ops",
    "idle_gaps"}: busy is the union of the device's kernels, copies and
    fills inside the profiled window; an idle gap is named by the
    innermost host operation running at its middle."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize(device)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function("chipbench.profiled"):
            fn()
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = _json(path)["traceEvents"]
    finally:
        os.remove(path)
    return summarize_trace(events)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_trace(events: List[dict]) -> dict:
    win = next(e for e in events if e.get("name") == "chipbench.profiled"
               and e.get("cat") == "user_annotation")
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((max(e["ts"], w0), min(e["ts"] + e["dur"], w1),
                        e["name"], e["dur"]))
        elif e.get("cat") == "cpu_op":
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    kernel_s: Dict[str, float] = {}
    for _, _, name, dur in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + dur * 1e-6
    # busy: the union of device intervals; the gaps between them
    busy, gaps, cur = 0.0, [], w0
    for a, b, _, _ in sorted(dev):
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1))
    host.sort()
    starts = [h[0] for h in host]
    by_host: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        name = "host outside any op"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(i - 4000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6

    def top(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"kernel_s": kernel_s, "busy_s": busy * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "device_ops": top(kernel_s),
            "idle_gaps": top(by_host)}


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_seconds(profile: Optional[dict], pattern: str) -> float:
    if not profile:
        return 0.0
    return sum(s for k, s in profile["kernel_s"].items() if pattern in k)


# ------------------------------------------------------------ the command
def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device) -> Run:
    return driver(cell).run(cell, device, seed, seconds, trace)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def result_line(bench: dict, cell: Cell, run: Run, trace: bool,
                kind: str, count: int) -> dict:
    checks = compare.judge(run.numbers, cell.limits)
    metrics = (read_layers(bench, cell, run) if trace
               else e2e_metrics(bench, cell, run))
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": run.memory_peak_bytes}
    out: Dict[str, Any] = {
        "correct": compare.passed(checks) and run.failed == 0,
        "attempted": run.attempted, "failed": run.failed,
        "metrics": metrics, "device": device}
    if trace and run.profile:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = load_cell(args.workload)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    loaded = sorted({n.split(".")[0] for n in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"chipbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    line = result_line(bench, cell, run, bool(args.trace), kind, chips)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"chipbench: {args.workload} seed {args.seed}: host peak RSS "
          f"{rss} B; card {power_limit()}; "
          f"{json.dumps(dict(run.extra, **run.e2e), sort_keys=True)}",
          flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if compare.within(c) else 'FAIL'}", file=sys.stderr)
    for name in cell.limits.get("not_compared", ()):
        print(f"read {name} = {run.numbers.get(name)!r} (not compared)",
              file=sys.stderr)
    print(f"check attempted {run.attempted} failed {run.failed}",
          file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
