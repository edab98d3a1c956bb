"""Roofline analysis: compute / memory / collective terms per
(architecture x input shape) on the production mesh (port of
``repro.analysis.roofline``), with one NVIDIA H100's constants
(``launch.mesh``):

    compute_term    = FLOPs_per_device / peak FLOP/s of the compute dtype
    memory_term     = HBM_bytes_per_device / HBM_BW
    collective_term = collective_bytes_per_device / ICI_BW

FLOPs, bytes and collective bytes come from the segment-composed fake
runs of ``segments.compose`` (matrix-product FLOPs; eager, unfused bytes).
The peak is 989 TFLOP/s for a bf16 config and 67 TFLOP/s (f32 off the
tensor cores: the port turns TF32 off) for an f32 one; the record says
which (``peak_flops``). MODEL_FLOPS is the analytic 6·N_active·T (train)
/ 2·N_active·T (inference) divided across devices — its ratio to the
counted FLOPs exposes remat/masking/dispatch waste.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.roofline --arch qwen2-1.5b --shape train_4k
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.analysis.segments import compose
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, fake_world,
                                     make_local_mesh, make_production_mesh,
                                     peak_flops)
from repro_torch.models.registry import build_model


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step (global, all devices)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: one token


def roofline_terms(cfg, comp: Dict, chips: int, shape) -> Dict:
    """The three terms, the dominant one and the useful-FLOPs ratio of a
    ``compose`` result for ``cfg`` at ``shape`` on ``chips`` devices."""
    t = comp["total"]
    peak = peak_flops(cfg.compute_dtype)
    # on one device a collective crosses no link: it is at most a local
    # copy through HBM (one rank's all-gather copies its block into the
    # whole; its in-place all-reduce moves nothing)
    local = chips == 1
    terms = {
        "compute_s": t["flops"] / peak,
        "memory_s": (t["bytes"] + (t["coll_bytes"] if local else 0))
        / HBM_BW,
        "collective_s": 0.0 if local else t["coll_bytes"] / ICI_BW,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape) / chips
    return {
        "chips": chips,
        "flops_per_chip": t["flops"],
        "bytes_per_chip": t["bytes"],
        "coll_bytes_per_chip": t["coll_bytes"],
        "peak_flops": peak,
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "model_flops_per_chip": mf,
        "useful_flops_ratio": round(mf / t["flops"], 4) if t["flops"] else 0,
        "segments": comp["segments"],
    }


def roofline(arch: str, shape_id: str, *, multi_pod: bool = False,
             rules: Optional[dict] = None) -> Dict:
    """The roofline record of one combination, its segments run on rank 0
    of a fake group of 256 (512) ranks (created here and destroyed on the
    way out)."""
    cfg = get_config(arch)
    model = build_model(cfg)
    shape = INPUT_SHAPES[shape_id]
    chips = 512 if multi_pod else 256
    if rules is None:
        rules = cfg.rules(shape.kind)
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        with shd.use_mesh(mesh, rules):
            comp = compose(model, shape)
    return {"arch": arch, "shape": shape_id,
            "mesh": "2x16x16" if multi_pod else "16x16",
            **roofline_terms(cfg, comp, chips, shape)}


def local_roofline(cfg, shape, *, train_mode: str = "lowdiff_sharded"
                   ) -> Dict:
    """The roofline record of ``cfg`` at ``shape`` on the (1, 1) mesh of a
    fake group of one rank: the whole step on one device, as a one-card
    run takes it (``train_mode`` ``dense`` leaves out the compression)."""
    with fake_world(1):
        with shd.use_mesh(make_local_mesh(1, 1), cfg.rules(shape.kind)):
            comp = compose(build_model(cfg), shape, train_mode=train_mode)
    return {"arch": cfg.name, "shape": shape.name, "mesh": "1x1",
            **roofline_terms(cfg, comp, 1, shape)}


def measured_copy_bandwidth(nbytes: int = 1 << 26, iters: int = 5,
                            device=None) -> float:
    """Measured memory-copy bandwidth in bytes/s, 2x the copied size (one
    read and one write stream): on a CUDA ``device`` a device-to-device
    ``copy_`` timed with CUDA events; else this host's, with numpy (the
    replay roofline's denominator where the state lives in host RAM)."""
    import time as _time

    import numpy as np
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        src = torch.ones(nbytes, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        dst.copy_(src)                                  # warm-up
        ts = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / 1e3)
        del src, dst
        return 2.0 * nbytes / float(np.median(ts))
    src = np.ones(nbytes, np.uint8)
    dst = np.empty_like(src)
    ts = []
    for _ in range(iters):
        t0 = _time.perf_counter()
        np.copyto(dst, src)
        ts.append(_time.perf_counter() - t0)
    return 2.0 * nbytes / float(np.median(ts))


def replay_roofline(state_bytes: int, payload_bytes: int, n_diffs: int,
                    bandwidth: Optional[float] = None, device=None) -> Dict:
    """Memory-bandwidth lower bound for replaying ``n_diffs``
    differentials through a stateful optimizer: each step must read and
    write the full optimizer state (params + both f32 moments) once and
    read its compressed payload — nothing less recovers Adam exactly.
    ``payload_bytes`` is per differential. The bandwidth: ``bandwidth``
    if given, else :data:`HBM_BW` for a CUDA ``device`` and this host's
    measured copy bandwidth for the CPU."""
    import torch
    if bandwidth:
        bw = bandwidth
    elif device is not None and torch.device(device).type == "cuda":
        bw = HBM_BW
    else:
        bw = measured_copy_bandwidth()
    traffic = n_diffs * (2 * state_bytes + payload_bytes)
    return {"traffic_bytes": int(traffic), "bandwidth": float(bw),
            "min_seconds": traffic / bw}


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results/roofline_torch.json")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()

    from repro_torch.configs import ASSIGNED_ARCHS
    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    for arch in archs:
        for shape_id in shapes:
            if (arch, shape_id, mesh_name) in done:
                continue
            try:
                rec = roofline(arch, shape_id, multi_pod=args.multi_pod)
            except Exception as e:  # noqa: BLE001
                import traceback
                rec = {"arch": arch, "shape": shape_id, "mesh": mesh_name,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc(limit=4)}
            if "error" in rec:
                print(f"[FAIL] {arch:24s} {shape_id:12s} {rec['error']}",
                      flush=True)
            else:
                print(f"[OK ] {arch:24s} {shape_id:12s} "
                      f"comp={rec['compute_s'] * 1e3:8.2f}ms "
                      f"mem={rec['memory_s'] * 1e3:8.2f}ms "
                      f"coll={rec['collective_s'] * 1e3:8.2f}ms "
                      f"dom={rec['dominant']:10s} "
                      f"useful={rec['useful_flops_ratio']:.2f}", flush=True)
            results.append(rec)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
