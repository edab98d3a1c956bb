"""The dry-run and roofline tables as markdown, from the JSON that
``launch/dryrun.py`` and ``analysis/roofline.py`` write (port of
``repro.analysis.report``, unchanged: the two packages write the same
record keys, so either package's JSON reads here), plus
:func:`fit_table`, one cell per combination of both.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.report dryrun results/dryrun_torch.json
    PYTHONPATH=src python -m repro_torch.analysis.report roofline results/roofline_torch.json
    PYTHONPATH=src python -m repro_torch.analysis.report fit results/dryrun_torch.json results/roofline_torch.json
"""
from __future__ import annotations

import json
import sys


def gib(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(path: str) -> str:
    with open(path) as f:
        rows = json.load(f)
    out = ["| arch | shape | mesh | step | lower s | compile s | "
           "args GiB/dev | temp GiB/dev | peak GiB/dev | collectives "
           "(bytes/dev) |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"FAILED: {r.get('error', '?')} | | | | | | |")
            continue
        m, c = r["memory"], r["collectives"]
        colls = " ".join(f"{k}:{v / 2**20:.0f}M" for k, v in c.items()
                         if k not in ("total", "count") and v)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['step_kind']} | {r['lower_s']} | {r['compile_s']} | "
            f"{gib(m['argument_bytes'])} | {gib(m['temp_bytes'])} | "
            f"{gib(m['peak_bytes_est'])} | {colls} |")
    return "\n".join(out)


def roofline_table(path: str) -> str:
    with open(path) as f:
        rows = json.load(f)
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPS/chip | useful ratio | one-line lever |",
           "|---|---|---|---|---|---|---|---|---|"]
    LEVERS = {
        ("compute",): "larger per-chip tiles / drop masked-tile waste",
        ("memory",): "fewer activation passes (fusion), lower-precision "
                     "intermediates, remat policy",
        ("collective",): "fewer FSDP gather rounds (accum), sharding that "
                         "keeps tokens resident",
    }
    for r in rows:
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | ERROR {r['error']} "
                       "| | | | | | |")
            continue
        lever = LEVERS[(r["dominant"],)]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"**{r['dominant']}** | {r['model_flops_per_chip']:.3g} | "
            f"{r['useful_flops_ratio']:.2f} | {lever} |")
    return "\n".join(out)


#: one card's device memory (H100 SXM: 80 GB)
DEVICE_BYTES = 80e9


def fit_table(dryrun_path: str, roofline_path: str) -> str:
    """Architectures x shapes of one mesh: per combination the dry run's
    peak GiB a device (``!`` above 80 GB) or its error, its collective
    GB a device, and the roofline's dominant term."""
    with open(dryrun_path) as f:
        dry = json.load(f)
    with open(roofline_path) as f:
        roof = {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)}
    shapes = list(dict.fromkeys(r["shape"] for r in dry))
    archs = list(dict.fromkeys(r["arch"] for r in dry))
    cell = {(r["arch"], r["shape"]): r for r in dry}
    out = ["| arch | " + " | ".join(shapes) + " |",
           "|---|" + "---|" * len(shapes)]
    for a in archs:
        row = []
        for sh in shapes:
            r = cell.get((a, sh))
            if r is None:
                row.append("")
            elif r.get("status") != "ok":
                row.append(f"fail: {r.get('error', '?')[:60]}")
            else:
                peak = r["memory"]["peak_bytes_est"]
                rr = roof.get((a, sh, r["mesh"]), {})
                row.append(f"{gib(peak)}{'!' if peak > DEVICE_BYTES else ''}"
                           f" / {r['collectives'].get('total', 0) / 1e9:.2f}"
                           f" / {rr.get('dominant', '?')}")
        out.append(f"| {a} | " + " | ".join(row) + " |")
    return "\n".join(out)


if __name__ == "__main__":
    kind, path = sys.argv[1], sys.argv[2]
    if kind == "fit":
        print(fit_table(path, sys.argv[3]))
    else:
        print(dryrun_table(path) if kind == "dryrun"
              else roofline_table(path))
