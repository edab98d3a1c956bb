"""Multi-pod dry run (port of ``repro.launch.dryrun``).

Runs the sharded step of every (architecture x input shape) combination
on the production meshes — (16, 16) single pod and (2, 16, 16) two pods
— as rank 0 of a process group of 256 or 512 ranks on torch's ``fake``
backend (``launch.mesh.fake_world``), under ``FakeTensorMode`` on the
CPU device: no byte of the state, the batch or any activation is
allocated, and no collective moves a byte. It records the memory the
step would hold on one device, its cost and its collectives from the op
record (``analysis.hlo_stats.OpRecorder``).

The CPU device, not fake CUDA tensors: the kernel wrappers then take
their plain versions, as the reference lowered its Pallas kernels in
interpret mode on fake CPU hosts (a fake CUDA tensor would reach the
wrappers' ``data_ptr()``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.analysis.hlo_stats import collective_bytes
from repro_torch.analysis.segments import fake_run, local_blocks, materialize
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.step_builder import (make_sharded_prefill_step,
                                                  make_sharded_serve_step,
                                                  make_sharded_train_step)
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.registry import build_model


def run_fake(step, args) -> dict:
    """Runs ``step(*args)`` (``args``: meta trees of this rank's shapes)
    in a fake run; returns its record: ``compile_s`` (the run's wall
    time), ``memory``, ``cost``, ``collectives`` and the recorder.

    ``memory``: ``argument_bytes`` are the live bytes of the arguments;
    ``peak_bytes_est`` is the most live bytes at any op, each storage
    counted from the op that made it to its death; ``output_bytes`` are
    the storages of the result that are not arguments; ``temp_bytes`` is
    the rest of the peak (peak - arguments - outputs); ``alias_bytes`` is
    0: the port's steps donate nothing."""
    t0 = time.time()
    with fake_run() as (fc, rec):
        live = materialize(args)
        arg_bytes = rec.track(live)
        arg_keys = set(rec.live_storages())
        out = step(*live)
        del live
        out_bytes = rec.held_bytes(out, exclude=arg_keys)
        del out
    return {
        "compile_s": round(time.time() - t0, 2),
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(out_bytes),
                   "temp_bytes": int(rec.peak_bytes - arg_bytes - out_bytes),
                   "alias_bytes": 0,
                   "peak_bytes_est": int(rec.peak_bytes)},
        "cost": {"flops": float(fc.get_total_flops()),
                 "bytes_accessed": float(rec.bytes_moved())},
        "collectives": collective_bytes(rec),
        "recorder": rec,
    }


def lower_combo(arch: str, shape_id: str, *, multi_pod: bool = False,
                train_mode: str = "lowdiff_sharded",
                rules: dict = None, keep_text: bool = False) -> dict:
    """Runs one combination on rank 0 of a fake group of 256 (512) ranks;
    returns the reference's dry-run record.

    ``lower_s`` is the time to build the step and its abstract inputs
    (this rank's blocks of the state and the batch); ``compile_s`` is the
    fake run's wall time (the port compiles nothing). Both are CPU
    seconds, no device's. ``keep_text`` keeps the op record, rendered in
    HLO syntax, as ``hlo_text``. Creates the process group and destroys
    it on the way out; refuses to run inside an initialised one."""
    cfg = get_config(arch)
    model = build_model(cfg)
    shape = INPUT_SHAPES[shape_id]
    rec = {"arch": arch, "shape": shape_id,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "mode": shape.kind, "status": "ok"}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        if rules is None:
            rules = cfg.rules(shape.kind)
        t0 = time.time()
        with shd.use_mesh(mesh, rules):
            if shape.kind == "decode":
                step, aps, acache, ab = make_sharded_serve_step(model, shape)
                args = (aps, acache, ab)
                rec["step_kind"] = "serve_step"
            elif shape.kind == "prefill":
                step, aps, ab = make_sharded_prefill_step(model, shape)
                args = (aps, ab)
                rec["step_kind"] = "prefill_step"
            else:
                step, ast, ab = make_sharded_train_step(model, shape,
                                                        mode=train_mode)
                args = (ast, ab)
                rec["step_kind"] = f"train_step[{train_mode}]"
            args = tuple(local_blocks(a) for a in args[:-1]) + args[-1:]
            rec["lower_s"] = round(time.time() - t0, 2)
            got = run_fake(step, args)
        rec["compile_s"] = got["compile_s"]
        rec["memory"] = got["memory"]
        rec["cost"] = got["cost"]
        rec["collectives"] = got["collectives"]
        rec["n_devices"] = mesh.size()
        if keep_text:
            rec["hlo_text"] = got["recorder"].text()
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--train-mode", default="lowdiff_sharded",
                    choices=["dense", "lowdiff_sharded"])
    ap.add_argument("--out", default=None, help="incremental JSON output")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "ok"}
    results = [r for r in results if (r["arch"], r["shape"], r["mesh"])
               in done]

    for mp in pods:
        mesh_name = "2x16x16" if mp else "16x16"
        for arch in archs:
            for shape_id in shapes:
                if (arch, shape_id, mesh_name) in done:
                    continue
                try:
                    rec = lower_combo(arch, shape_id, multi_pod=mp,
                                      train_mode=args.train_mode)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "shape": shape_id,
                           "mesh": mesh_name, "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc(limit=6)}
                tag = ("OK " if rec["status"] == "ok" else "FAIL")
                print(f"[{tag}] {mesh_name:8s} {arch:24s} {shape_id:12s} "
                      + (f"run={rec.get('compile_s')}s "
                         f"peak={rec['memory']['peak_bytes_est'] / 2**30:.1f}GiB"
                         if rec["status"] == "ok" else rec["error"]),
                      flush=True)
                results.append(rec)
                if args.out:
                    os.makedirs(os.path.dirname(args.out) or ".",
                                exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\n{n_ok}/{len(results)} combinations run on fake tensors")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
