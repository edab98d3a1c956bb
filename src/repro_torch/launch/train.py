"""End-to-end training driver (port of ``repro.launch.train``).

Runs a training loop on synthetic data with LowDiff, LowDiff+ or one of
the paper's baselines (``checkfreq``, ``gemini``, ``naive_dc``,
``full_sync``; dense steps) attached, or the bare dense step with
``--strategy none``; reports per-step times, and supports failure
injection + recovery (LowDiff+ recovers from its host replica, as the
reference does). Runs on the card unless ``--device cpu`` is given;
with no card and no ``--device cpu`` it raises instead of running. The
flags keep the reference's names and defaults; values that are not
ported are refused by ``choices``.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --steps 8 \\
        --full-interval 4 --fail-at 7 --ckpt-dir build/ck
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch gpt2-l --reduced --steps 8 --full-interval 4 --fail-at 7
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch gpt2-l --reduced --strategy lowdiff_plus \\
        --persist-mode incremental --dirty-granularity row \\
        --diff-quant int4 --steps 8 --fail-at 6
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch gpt2-l --reduced --compressor packed --steps 8 \\
        --full-interval 4 --fail-at 7
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch gpt2-l --reduced --strategy naive_dc --steps 8 \\
        --full-interval 4 --fail-at 7
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch gpt2-l --reduced --steps 8 --full-interval 4 --fail-at 7 \\
        --backend remote --remote-url fake://bkt --remote-fault-rate 0.05
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.backends import BACKENDS
from repro_torch.checkpoint.io import FORMATS
from repro_torch.configs import _REGISTRY, get_config
from repro_torch.core.engine import STRATEGIES, EngineConfig, make_engine
from repro_torch.core.steps import COMPRESSORS, init_state, make_train_step
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.registry import build_model
from repro_torch.obs.log import configure as configure_logging, get_logger
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.timeline import STALL_CATEGORIES, TIMELINE
from repro_torch.obs.trace import TRACER


def _stall_suffix(rec) -> str:
    parts = []
    for cat in STALL_CATEGORIES:
        if rec.get(cat, 0.0) > 0.0:
            parts.append(f"{cat}={rec[cat] * 1e3:.1f}ms")
    parts.append(f"stall%={TIMELINE.stall_fraction() * 100:.1f}")
    return " ".join(parts)


def _sync(device: torch.device) -> None:
    """Wait for the step's work on the training stream (as the
    reference blocks on the step's outputs); snapshot copies on the
    side stream keep running."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def run(args):
    configure_logging(getattr(args, "log_level", "info"))
    log = get_logger("train")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    log.info(f"arch={cfg.name} params={model.n_params() / 1e6:.1f}M "
             f"strategy={args.strategy} device={device}")
    if getattr(args, "clean", False) and args.ckpt_dir:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    engine_cfg = EngineConfig.from_args(args)
    TIMELINE.clear()
    if engine_cfg.trace_out:
        TRACER.enable(engine_cfg.trace_buffer)
    store = engine_cfg.build_store()
    strat = make_engine(engine_cfg, model, store=store)
    mode = (args.strategy if args.strategy in ("lowdiff", "lowdiff_plus")
            else "dense")
    state = init_state(model, args.seed, mode=mode, device=device)
    plain_step = make_train_step(model, mode=mode, lr=args.lr, rho=args.rho)
    stream = TokenStream(cfg, args.seq, args.batch, seed=args.seed,
                         device=device)

    losses, times = [], []
    t_start = time.perf_counter()
    for t in range(args.steps):
        batch = next(stream)
        t0 = time.perf_counter()
        TIMELINE.begin(t + 1)
        if strat is not None:
            state, metrics = strat.train_step(state, batch)
        else:
            state, metrics, _ = plain_step(state, batch)
        _sync(device)
        step_wall = time.perf_counter() - t0
        rec = TIMELINE.commit(t + 1, step_wall)
        times.append(step_wall)
        losses.append(float(metrics["loss"]))
        if args.log_every and (t + 1) % args.log_every == 0:
            log.info(f"step {t + 1:5d} loss={losses[-1]:.4f} "
                     f"it={np.mean(times[-args.log_every:]) * 1e3:.1f}ms "
                     + _stall_suffix(rec))
        if args.fail_at and t + 1 == args.fail_at:
            log.info(f"\n*** injected failure at step {t + 1} ***")
            assert strat is not None, "--fail-at needs a strategy"
            strat.flush()
            if args.strategy == "lowdiff_plus":
                state = strat.recover_software(state)
            else:
                del state
                state, n = strat.recover()
            log.info(f"recovered at step {int(state['step'])}; resuming\n")
            stream.step = int(state["step"])

    wall = time.perf_counter() - t_start
    if strat is not None:
        strat.close()
    elif store is not None:
        store.close()
    log.info(f"\n{args.steps} steps in {wall:.1f}s "
             f"(mean iter {np.mean(times) * 1e3:.1f}ms, "
             f"p50 {np.percentile(times, 50) * 1e3:.1f}ms)")
    log.info(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if strat is not None:
        log.info(f"strategy stats: {strat.stats()}")
    if engine_cfg.trace_out:
        n = TRACER.export_chrome(engine_cfg.trace_out)
        log.info(f"wrote {n} trace events -> {engine_cfg.trace_out}")
    if engine_cfg.metrics_out:
        extras = [{"kind": "metric", **m} for m in REGISTRY.collect()]
        n = TIMELINE.write_jsonl(engine_cfg.metrics_out, extra=extras)
        log.info(f"wrote {n} records -> {engine_cfg.metrics_out}")
    return losses, times


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-l", choices=sorted(_REGISTRY))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rho", type=float, default=0.01)
    ap.add_argument("--strategy", choices=STRATEGIES, default="lowdiff")
    ap.add_argument("--full-interval", type=int, default=20,
                    help="full-checkpoint interval f (0 = Eq. (10) optimum "
                         "+ online tuning)")
    ap.add_argument("--batch-size", type=int, default=2,
                    help="differential batching size b (0 = Eq. (10) "
                         "optimum + online tuning)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"),
                    help="checkpoint root (default: repro_ckpt under the "
                         "temporary directory, i.e. $TMPDIR); wiped at "
                         "launch by --clean")
    ap.add_argument("--backend", choices=BACKENDS, default="local",
                    help="checkpoint storage backend (local FS, CPU-memory "
                         "tier with async write-back, sharded concurrent, "
                         "or a remote object store under a RAM tier)")
    ap.add_argument("--format", choices=FORMATS, default="frame",
                    help="checkpoint serialization: 'frame' (streamed "
                         "zero-copy, memmap reads) or 'npz' (legacy); "
                         "reads sniff, so old chains recover either way")
    ap.add_argument("--compressor", choices=COMPRESSORS, default="topk",
                    help="lowdiff gradient compression: topk sparsification, "
                         "quant8 blockwise int8, or packed (fused top-k + "
                         "int8 + wire pack in one kernel)")
    ap.add_argument("--shards", type=int, default=4,
                    help="shard count for --backend sharded")
    ap.add_argument("--memory-capacity-mb", type=float, default=None,
                    help="RAM-tier byte budget for --backend memory/remote")
    ap.add_argument("--remote-url", default=None,
                    help="object store for --backend remote: fake://bucket "
                         "(in-process) or file:///path (directory-backed); "
                         "default file://<ckpt-dir>")
    ap.add_argument("--chunk-mb", type=float, default=4.0,
                    help="remote-tier content chunk size in MiB")
    ap.add_argument("--max-retries", type=int, default=4,
                    help="bounded retries per remote chunk transfer")
    ap.add_argument("--remote-fault-rate", type=float, default=0.0,
                    help="injected transient-fault probability on fake:// "
                         "stores (exercises retry/backoff)")
    ap.add_argument("--eviction", choices=("fifo", "lru"), default="fifo",
                    help="memory-tier eviction policy over size-class "
                         "buckets; lru refreshes recency on recovery reads")
    ap.add_argument("--persist-mode", choices=("full", "incremental"),
                    default="full",
                    help="lowdiff_plus persistence: 'full' rewrites the "
                         "whole replica every persist; 'incremental' "
                         "writes only the leaves that changed since the "
                         "last persist as a patch chain on a base full, "
                         "folded back in the background (requires "
                         "--format frame)")
    ap.add_argument("--persist-threshold", type=float, default=0.0,
                    help="incremental persist filter: defer re-persisting "
                         "a dirty leaf until its accumulated relative "
                         "L-inf change exceeds this (0 = exact: persist "
                         "every changed leaf)")
    ap.add_argument("--dirty-granularity", choices=("leaf", "row"),
                    default="leaf",
                    help="incremental persist unit: 'leaf' re-persists "
                         "whole changed arrays; 'row' tracks dirtiness "
                         "per first-axis row and patches only the "
                         "changed row ranges")
    ap.add_argument("--diff-quant", choices=("off", "int8", "int4"),
                    default="off",
                    help="quantize row-span patch payloads on the wire "
                         "(per-row-block absmax scales, error-feedback "
                         "residuals; requires --persist-mode incremental "
                         "--dirty-granularity row)")
    ap.add_argument("--fold-interval", type=int, default=16,
                    help="fold the patch chain into its base frame after "
                         "this many incremental persists (0 = never)")
    ap.add_argument("--fold-amplification", type=float, default=1.5,
                    help="also fold when chain overlay bytes divided by "
                         "base frame bytes reach this ratio (0 = "
                         "disable the adaptive trigger; --fold-interval "
                         "stays as the hard cap)")
    ap.add_argument("--replay-window", type=int, default=0,
                    help="differentials per replay window: bounds the "
                         "compressed payloads staged on the device by "
                         "parallel and device replay (0 = one window; "
                         "parallel replay's dense scratch is bounded "
                         "apart from it)")
    ap.add_argument("--replay-device", choices=("on", "off"), default="off",
                    help="recovery replay: 'on' stages the compressed "
                         "payloads on the device per window and replays "
                         "them through the compressor's fused apply "
                         "kernel (bitwise equal to the trained state); "
                         "'off' runs the log-depth parallel replay")
    ap.add_argument("--snapshot-shards", type=int, default=4,
                    help="full snapshots land in this many shards, each "
                         "shard's device buffers released as it lands")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON of the pipeline "
                         "spans here; also enables the span tracer")
    ap.add_argument("--metrics-out", default=None,
                    help="write per-step stall-attribution records and the "
                         "final metrics-registry collection as JSON Lines")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="span ring-buffer capacity")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--clean", action="store_true", default=True)
    ap.add_argument("--fail-at", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-level", default="info",
                    choices=("debug", "info", "warning", "error"))
    return ap


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
