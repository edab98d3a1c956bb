#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # every phase, full-width gpt2-l

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel);
2. hold each kernel against its plain torch version on the card, on
   every leaf shape of full-width gpt2-l (K1/K2 exact, K3/K4 bitwise),
   plus edge cases (ragged tails, zero blocks, exact ties, k in
   {1, 11, 103}, k == 0, bfloat16), and time kernel, plain version and
   the nearest single PyTorch call over one step's worth of leaves;
3. drive the main path: ``LowDiff`` on full-width gpt2-l (batch 4, seq
   64, f=4, b=2) for 7 steps, flush, inject a failure, recover with
   device replay, and require the recovered params/opt to equal the
   trained ones bit for bit; check that K1, K2 and K4 launched;
4. three ``--strategy none`` (dense) steps, which launch K3;
5. print the ``kernels`` JSON line, the card's name and power limit,
   and the result line.

Exits non-zero without a CUDA device, and when run outside the repo.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
REPS = 20                        # timed repetitions per kernel


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype in (torch.float32, torch.int32):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def abs_err(a, b) -> float:
    """Largest |a - b| over the elements, as f32 differences."""
    if a.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phase 1
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build()
    for name in build.SOURCES:
        build.lib(name)
    log(f"[build] nvcc x{len(secs)} in parallel: "
        f"{time.perf_counter() - t0:.2f} s "
        + " ".join(f"{k}={v:.2f}s" for k, v in secs.items()))
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 2
def _leaf_shapes(cfg):
    from repro_torch import tree_leaves
    from repro_torch.models import lm
    from repro_torch.models.param import is_spec
    return [tuple(s.shape) for s in tree_leaves(lm.param_specs(cfg),
                                                is_leaf=is_spec)]


def _edge_cases(dev, err):
    """Small inputs that exercise ties, zero blocks, ragged tails, k
    extremes and bfloat16 — exact/bitwise against the plain versions.
    Raises each kernel's entry of ``err`` to its largest |kernel - plain|."""
    import torch
    from repro_torch.kernels import fused_adam, ref, replay, topk
    from repro_torch.kernels.ops import adam_hyper_traced
    g = torch.Generator(device=dev).manual_seed(7)
    ties = torch.randint(-3, 4, (5 * 1024 + 300,), generator=g,
                         device=dev).float()
    ties[1024:2048] = 0.0                     # an all-zero block
    cases = [ties, torch.randn(2500, generator=g, device=dev),
             torch.randn(3000, generator=g, device=dev).to(torch.bfloat16)]
    hyper = adam_hyper_traced(1e-3, 0.9, 0.999, 1e-8,
                              torch.tensor(3, dtype=torch.int32, device=dev))
    n_checks = 0
    for x in cases:
        for k in (1, 11, 103):
            v, i = topk.topk_select(x, k)
            rv, ri = ref.topk_select_ref(ref.to_blocks(x, 1024)[0], k)
            err["topk_select"] = max(err["topk_select"], abs_err(v, rv),
                                     abs_err(i, ri))
            if not (torch.equal(i, ri) and bits_equal(v, rv)):
                fail(f"K1 edge case {x.dtype} n={x.numel()} k={k}")
            d = topk.topk_scatter(v, i, x.numel())
            rd = ref.topk_scatter_ref(rv, ri, 1024).reshape(-1)[:x.numel()]
            err["topk_scatter"] = max(err["topk_scatter"], abs_err(d, rd))
            if not bits_equal(d, rd):
                fail(f"K2 edge case {x.dtype} n={x.numel()} k={k}")
            p = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
            mu = torch.randn(x.shape, generator=g, device=dev) * 0.1
            nu = torch.rand(x.shape, generator=g, device=dev) * 0.01
            for kk in (k, 0):
                vv, ii = v[:, :kk].contiguous(), i[:, :kk].contiguous()
                out = replay.topk_apply(vv, ii, p, mu, nu, hyper)
                pb, mub, nub = (ref.to_blocks(t, 1024)[0] for t in (p, mu, nu))
                rout = ref.topk_apply_ref(vv, ii, pb, mub, nub, hyper,
                                          block=1024)
                for a, b in zip(out, rout):
                    b = ref.unblock(b, x.shape)
                    err["topk_apply"] = max(err["topk_apply"], abs_err(a, b))
                    if not bits_equal(a, b):
                        fail(f"K4 edge case {x.dtype} n={x.numel()} k={kk}")
            out = fused_adam.adam_tile_update(p, x, mu, nu, hyper)
            rout = ref.adam_tile_update_ref(p, x, mu, nu, hyper)
            err["adam_tile_update"] = max(
                err["adam_tile_update"],
                *(abs_err(a, b) for a, b in zip(out, rout)))
            if not all(bits_equal(a, b) for a, b in zip(out, rout)):
                fail(f"K3 edge case {x.dtype} n={x.numel()}")
            n_checks += 5
    log(f"[parity] edge cases: {n_checks} kernel/plain comparisons equal")


def phase_parity(cfg, dev, reps: int = REPS):
    """Each kernel against its plain version on every leaf shape of
    ``cfg`` (one training step's worth), plus the timings. Each kernel's
    ``max_abs_err`` is its largest |kernel - plain| over every compared
    output, leaves and edge cases."""
    import torch
    from repro_torch.compression.sparse import k_for
    from repro_torch.kernels import fused_adam, ref, replay, topk
    from repro_torch.kernels.ops import adam_hyper_traced
    err = {k: 0.0 for k in ("topk_select", "topk_scatter",
                            "adam_tile_update", "topk_apply")}
    _edge_cases(dev, err)
    shapes = _leaf_shapes(cfg)
    n_all = sum(math.prod(s) for s in shapes)
    big = max(shapes, key=math.prod)
    k = k_for(0.01)
    g = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    nbs = [-(-x.numel() // 1024) for x in xs]
    nb_all = sum(nbs)
    log(f"[parity] gpt2-l leaves: {len(shapes)}, {n_all} elements, "
        f"{nb_all} blocks (largest leaf {big}: {math.prod(big) // 1024} "
        f"blocks), k={k}")
    res = {}

    # K1 -------------------------------------------------------------
    outs = [topk.topk_select(x, k) for x in xs]
    for x, (v, i) in zip(xs, outs):
        rv, ri = ref.topk_select_ref(ref.to_blocks(x, 1024)[0], k)
        err["topk_select"] = max(err["topk_select"], abs_err(v, rv),
                                 abs_err(i, ri))
        if not (torch.equal(i, ri) and bits_equal(v, rv)):
            fail(f"K1 topk_select != plain version on leaf {tuple(x.shape)}")
        del rv, ri
    log("[parity] K1 topk_select: indices and values exactly equal on "
        "every leaf")
    ms = timed(lambda: [topk.topk_select(x, k) for x in xs], reps)
    plain = timed(lambda: [ref.topk_select_ref(ref.to_blocks(x, 1024)[0], k)
                           for x in xs], max(1, reps // 5))
    xbs = [ref.to_blocks(x, 1024)[0] for x in xs]
    lib = timed(lambda: [torch.topk(xb.abs(), k, dim=1) for xb in xbs],
                max(1, reps // 2))
    del xbs
    nbytes = 4 * n_all + 8 * k * nb_all
    res["topk_select"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bytes=nbytes, ops=2 * k * 1024 * nb_all)

    # K2 -------------------------------------------------------------
    for x, (v, i) in zip(xs, outs):
        d = topk.topk_scatter(v, i, x.numel())
        rd = ref.topk_scatter_ref(v, i, 1024).reshape(-1)[:x.numel()]
        err["topk_scatter"] = max(err["topk_scatter"], abs_err(d, rd))
        if not bits_equal(d, rd):
            fail(f"K2 topk_scatter != plain version on leaf {tuple(x.shape)}")
    log("[parity] K2 topk_scatter: exactly equal on every leaf")
    ms = timed(lambda: [topk.topk_scatter(v, i, x.numel())
                        for x, (v, i) in zip(xs, outs)], reps)
    plain = timed(lambda: [ref.topk_scatter_ref(v, i, 1024)
                           for v, i in outs], max(1, reps // 2))
    zs = [torch.zeros((nb, 1024), device=dev) for nb in nbs]
    i64 = [i.long() for _, i in outs]
    lib = timed(lambda: [z.scatter_(1, i, v) for z, i, (v, _)
                         in zip(zs, i64, outs)], reps)
    del zs, i64
    res["topk_scatter"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bytes=4 * n_all + 8 * k * nb_all,
                               ops=k * nb_all)

    # K3 / K4 --------------------------------------------------------
    count = torch.tensor(3, dtype=torch.int32, device=dev)
    hyper = adam_hyper_traced(1e-3, 0.9, 0.999, 1e-8, count)
    ps = xs
    gs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    mus = [torch.randn(s, generator=g, device=dev) * 0.1 for s in shapes]
    nus = [torch.rand(s, generator=g, device=dev) * 0.01 for s in shapes]
    for p, gg, mu, nu in zip(ps, gs, mus, nus):
        out = fused_adam.adam_tile_update(p, gg, mu, nu, hyper)
        rout = ref.adam_tile_update_ref(p, gg, mu, nu, hyper)
        err["adam_tile_update"] = max(
            err["adam_tile_update"],
            *(abs_err(a, b) for a, b in zip(out, rout)))
        if not all(bits_equal(a, b) for a, b in zip(out, rout)):
            fail(f"K3 adam_tile_update not bitwise equal to plain version "
                 f"on leaf {tuple(p.shape)}")
    log("[parity] K3 adam_tile_update: bitwise equal on every leaf")
    ms = timed(lambda: [fused_adam.adam_tile_update(*a, hyper)
                        for a in zip(ps, gs, mus, nus)], reps)
    plain = timed(lambda: [ref.adam_tile_update_ref(*a, hyper)
                           for a in zip(ps, gs, mus, nus)], max(1, reps // 2))
    lib = None
    if hasattr(torch, "_fused_adam_"):
        lp = [p.clone() for p in ps]
        lm_, lv = [m.clone() for m in mus], [v.clone() for v in nus]
        steps = [torch.tensor(3.0, device=dev) for _ in ps]
        lib = timed(lambda: torch._fused_adam_(
            lp, gs, lm_, lv, [], steps, lr=1e-3, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False),
            reps)
        del lp, lm_, lv
    res["adam_tile_update"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                   bytes=28 * n_all, ops=13 * n_all)
    del gs

    for (v, i), p, mu, nu in zip(outs, ps, mus, nus):
        out = replay.topk_apply(v, i, p, mu, nu, hyper)
        pb, mub, nub = (ref.to_blocks(t, 1024)[0] for t in (p, mu, nu))
        rout = [ref.unblock(b, p.shape) for b in
                ref.topk_apply_ref(v, i, pb, mub, nub, hyper, block=1024)]
        err["topk_apply"] = max(err["topk_apply"],
                                *(abs_err(a, b) for a, b in zip(out, rout)))
        if not all(bits_equal(a, b) for a, b in zip(out, rout)):
            fail(f"K4 topk_apply not bitwise equal to plain version on "
                 f"leaf {tuple(p.shape)}")
        del pb, mub, nub, rout
    log("[parity] K4 topk_apply: bitwise equal on every leaf")
    ms = timed(lambda: [replay.topk_apply(v, i, p, mu, nu, hyper)
                        for (v, i), p, mu, nu in zip(outs, ps, mus, nus)],
               reps)

    def plain_k4():
        for (v, i), p, mu, nu in zip(outs, ps, mus, nus):
            pb, mub, nub = (ref.to_blocks(t, 1024)[0] for t in (p, mu, nu))
            ref.topk_apply_ref(v, i, pb, mub, nub, hyper, block=1024)
    plain = timed(plain_k4, max(1, reps // 2))
    res["topk_apply"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                             bytes=24 * n_all + 8 * k * nb_all,
                             ops=13 * n_all)
    del xs, outs, ps, mus, nus
    torch.cuda.empty_cache()
    for name, r in res.items():
        r["max_abs_err"] = err[name]
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["ops"] / FP32_FLOPS)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["ops"] / FP32_FLOPS else "operations")
        log(f"[timing] {name}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"library_ms={r['library_ms']} max_abs_err={r['max_abs_err']} "
            f"(one step's leaves, "
            f"{r['bytes'] / 1e9:.3f} GB)")
    return res


# ---------------------------------------------------------------- phase 3
def _small_reference_check(dev):
    """Reduced gpt2-l: one lowdiff step on the card (kernels) against the
    same step on the CPU (plain versions), from the same params/batch."""
    import torch
    from repro_torch import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.steps import init_state, make_train_step
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.registry import build_model
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    cpu = init_state(model, 0, device="cpu")
    gpu = init_state(model, 0, device=dev, params={
        k: v for k, v in _to(cpu["params"], dev).items()})
    step = make_train_step(model)
    b = make_batch(cfg, 64, 2, step=0)
    s_cpu, m_cpu, cg_cpu = step(cpu, b)
    s_gpu, m_gpu, cg_gpu = step(gpu, {k: v.to(dev) for k, v in b.items()})
    lc, lg = float(m_cpu["loss"]), float(m_gpu["loss"])
    if not (math.isfinite(lg) and abs(lc - lg) <= 1e-4 * abs(lc)):
        fail(f"reduced-step loss card {lg} vs cpu {lc}")
    agree = tot = 0
    for a, b_ in zip(tree_leaves(cg_cpu), tree_leaves(cg_gpu)):
        if a.dtype == torch.int32:
            rows = (a == b_.cpu()).all(dim=1)
            agree += int(rows.sum())
            tot += rows.numel()
    if agree < 0.999 * tot:
        fail(f"reduced-step top-k rows agree {agree}/{tot}")
    log(f"[reference] reduced gpt2-l step card vs cpu: loss {lg:.6f} vs "
        f"{lc:.6f}, top-k rows agree {agree}/{tot}")


def _to(tree, dev):
    from repro_torch import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def phase_main(cfg, dev, ckdir: str, steps: int = 7, fail_at: int = 7):
    import torch
    from repro_torch import tree_leaves
    from repro_torch.checkpoint.io import COPY_METER
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.compression.sparse import tree_nbytes
    from repro_torch.core.lowdiff import LowDiff
    from repro_torch.core.steps import init_state
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import build
    from repro_torch.models.registry import build_model
    from repro_torch.obs.trace import TRACER
    _small_reference_check(dev)
    shutil.rmtree(ckdir, ignore_errors=True)
    model = build_model(cfg)
    log(f"[main] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{model.n_params()} params; LowDiff topk rho=0.01 + EF, f=4, b=2, "
        f"batch 4 x seq 64, device replay")
    TRACER.clear()
    TRACER.enable()
    store = CheckpointStore(ckdir)
    strat = LowDiff(model, store, rho=0.01, lr=1e-3, full_interval=4,
                    batch_size=2, replay_device=True, device=dev,
                    flush_timeout=3600.0)
    state = init_state(model, 0, device=dev)
    stream = TokenStream(cfg, 64, 4, seed=0, device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    step_ms, losses, diff_bytes = [], [], []
    orig_step = strat.step_fn

    def step_fn(st, b):             # records each step's payload size
        out = orig_step(st, b)
        diff_bytes.append(tree_nbytes(out[2]))
        return out
    strat.step_fn = step_fn
    for t in range(steps):
        batch = next(stream)
        t0 = time.perf_counter()
        state, metrics = strat.train_step(state, batch)
        torch.cuda.current_stream(dev).synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    if not all(math.isfinite(l) for l in losses):
        fail(f"non-finite loss {losses}")
    log(f"[main] step_ms={[round(s, 3) for s in step_ms]} "
        f"losses={[round(l, 5) for l in losses]}")
    log(f"[main] differential bytes per step: {diff_bytes[-1]} "
        f"(dense f32 gradient {4 * model.n_params()})")
    trained = [t.clone() for t in tree_leaves(state["params"])
               + tree_leaves(state["opt"])]
    t0 = time.perf_counter()
    strat.flush()
    flush_s = time.perf_counter() - t0
    log(f"*** injected failure at step {fail_at} ***")
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state, applied = strat.recover()
    torch.cuda.synchronize()
    rec_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(build.LAUNCHES)
    recovered = tree_leaves(state["params"]) + tree_leaves(state["opt"])
    if int(state["step"]) != fail_at or applied != fail_at - 4:
        fail(f"recovered step {int(state['step'])}, applied {applied}")
    if len(recovered) != len(trained) or not all(
            bits_equal(a, b) for a, b in zip(trained, recovered)):
        fail("recovered params/opt differ from the trained state")
    log(f"[main] recovered at step {int(state['step'])}; {applied} "
        f"differentials replayed; params+opt bitwise equal to the trained "
        f"state ({len(trained)} leaves)")
    spans = {}
    for name, _, _, _, t0_, t1_, _ in TRACER.events():
        spans[name] = spans.get(name, 0.0) + (t1_ - t0_) * 1e3
    TRACER.disable()
    log(f"[main] snapshot_ms(d2h, all snapshots)="
        f"{spans.get('snapshot.d2h', 0.0):.1f} "
        f"persist_full_ms={spans.get('store.save_full', 0.0):.1f} "
        f"persist_batch_ms={spans.get('store.save_batch', 0.0):.1f} "
        f"flush_s={flush_s:.2f} recovery_ms={rec_ms:.1f} "
        f"(load_chain_ms={spans.get('recovery.load_chain', 0.0):.1f} "
        f"replay_ms={spans.get('recovery.replay', 0.0):.1f}) "
        f"full_bytes={store.manifest['fulls'][0]['bytes']} "
        f"copy_meter={COPY_METER.stats()}")
    log(f"[main] launches: {launches}")
    for k in ("topk_select", "topk_scatter", "topk_apply"):
        if launches[k] <= 0:
            fail(f"main path did not launch {k}")
    strat.close()
    del state, trained, recovered, strat
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 4
def phase_dense(cfg, dev, steps: int = 3):
    import torch
    from repro_torch.core.steps import init_state, make_train_step
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import build
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    state = init_state(model, 0, mode="dense", device=dev)
    step = make_train_step(model, mode="dense")
    stream = TokenStream(cfg, 64, 4, seed=0, device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    step_ms, losses = [], []
    for _ in range(steps):
        b = next(stream)
        t0 = time.perf_counter()
        state, metrics, _ = step(state, b)
        torch.cuda.current_stream(dev).synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = dict(build.LAUNCHES)
    if launches["adam_tile_update"] <= 0:
        fail("--strategy none did not launch adam_tile_update")
    if not all(math.isfinite(l) for l in losses):
        fail(f"non-finite dense loss {losses}")
    log(f"[dense] step_ms={[round(s, 3) for s in step_ms]} "
        f"losses={[round(l, 5) for l in losses]} launches={launches}")
    del state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- profile
def phase_profile(cfg, dev, steps: int = 2):
    """``--profile``: torch.profiler over warm lowdiff and dense steps
    (no checkpointing): device time by kernel and the device's busy
    share of the (profiled) step wall; the same steps are first timed
    without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.steps import init_state, make_train_step
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    for mode in ("lowdiff", "dense"):
        state = init_state(model, 0, mode=mode, device=dev)
        step = make_train_step(model, mode=mode)
        stream = TokenStream(cfg, 64, 4, seed=0, device=dev)
        for _ in range(2):                       # warm-up
            state, _, _ = step(state, next(stream))
        torch.cuda.synchronize()
        batches = [next(stream) for _ in range(steps)]
        t0 = time.perf_counter()
        for b in batches:
            state, _, _ = step(state, b)
        torch.cuda.synchronize()
        plain_wall = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                state, _, _ = step(state, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        kern = [e for e in prof.events()
                if str(e.device_type).endswith("CUDA")]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / steps
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / steps
        log(f"[profile] {mode}: step wall {plain_wall:.2f} ms unprofiled, "
            f"{wall:.2f} ms profiled; device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
            f"{len(kern) // steps} device ops per step")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
            log(f"[profile] {mode}:   {ms:9.3f} ms  {name[:110]}")
        del state
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- main
KERNELS = [
    ("topk_select", "src/repro_torch/kernels/csrc/topk.cu",
     "src/repro/kernels/topk.py:24"),
    ("topk_scatter", "src/repro_torch/kernels/csrc/topk.cu",
     "src/repro/kernels/topk.py:67"),
    ("adam_tile_update", "src/repro_torch/kernels/csrc/fused_adam.cu",
     "src/repro/kernels/fused_adam.py:20"),
    ("topk_apply", "src/repro_torch/kernels/csrc/replay.cu",
     "src/repro/kernels/replay.py:69"),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("all", "kernels"), default="all")
    ap.add_argument("--profile", action="store_true",
                    help="also profile warm lowdiff and dense steps")
    ap.add_argument("--ckpt-dir", default=os.path.join(HERE, "build",
                                                       "chip_smoke_ckpt"))
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        fail("run from a checkout of the repository (src/repro_torch "
             "not found beside chip_smoke.py)")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"({smi})")
    t_all = time.perf_counter()
    from repro_torch.configs import get_config
    cfg = get_config("gpt2-l")

    phase_build()
    res = phase_parity(cfg, dev)
    launches = {k: 0 for k in res}
    if args.only == "all":
        launches.update({k: v for k, v in phase_main(
            cfg, dev, args.ckpt_dir).items() if k != "adam_tile_update"})
        launches["adam_tile_update"] = phase_dense(cfg, dev)[
            "adam_tile_update"]
    if args.profile:
        phase_profile(cfg, dev)
    kernels = []
    for name, source, replaces in KERNELS:
        r = res[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
