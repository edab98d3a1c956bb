#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # every phase, full-width gpt2-l

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the CUDA sources from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, all started together);
2. hold K1-K4 against their plain torch versions on the card, on every
   leaf shape of full-width gpt2-l (K1/K2 exact, K3/K4 bitwise), plus
   edge cases (ragged tails, zero blocks, exact ties, k in
   {1, 11, 103}, k == 0, bfloat16), and time kernel, plain version and
   the nearest single PyTorch call over one step's worth of leaves; then
   the same for K8-K13, the packed and quant8 compressors (bitwise, K8's
   indices also equal to K1's), with their edge cases (ragged last
   block, all-zero block, ties, half steps, bf16 params, k == 0). K1 and
   K8 also meet the selection's adversarial inputs (``_select_inputs``:
   signed zeros, blocks with exactly and fewer than k nonzeros, an
   embedding-like tensor, heavy tails, many tied maxima) at k in {1, 2,
   11, 31, 32, 33, 103, 1024}; K1 is timed at k = 1, 11 and 32
   (``[diagnose]``), and each timed input set prints the share of its
   blocks that the selection takes through each path (``[paths]``);
A. hold K5-K7 (the int8/int4 row-span codec) against their plain
   versions, bitwise, on every gpt2-l leaf as LowDiff+ quantizes it and
   on edge cases (cols 1 and odd, n 1 and 9, zero rows, bf16 leaves, a
   row wider than the grid's shared memory, which K5 packs on its
   two-pass path), and K5/K6 against the numpy codec on a row slice of
   each leaf; print K5's plan per leaf and the rows and elements of each
   of its paths (``[paths] span_pack``); time them over one step's worth
   of rows (K5 at int8 and int4, K6 beside ``torch.mul(q, scale)``);
3. drive the LowDiff path: ``LowDiff`` on full-width gpt2-l (batch 4,
   seq 64, the CLI's f=20, b=2), resumed at step 19 so that its 20 steps
   write a full and then the longest chain those defaults produce (19
   differentials); flush, inject a failure, recover with device replay
   and require the recovered params/opt to equal the trained ones bit
   for bit; recover again with the default parallel replay, within its
   reassociation tolerance, and report its time and peak device memory;
   check that K1, K2 and K4 launched; K4 and K2 are held to their
   plain versions on the last step's own leaves and payload, and after
   the flush K1 is held to its plain version and timed on the run's own
   error-feedback residual (``[residual]``; launches of these checks
   are not counted as the path's);
4. three ``--strategy none`` (dense) steps, which launch K3; K3 is held
   to its plain version on the last step's leaves;
B. drive the LowDiff+ path: ``LowDiffPlus`` (incremental, row, int4
   with int8 moments) on full-width gpt2-l for 3 steps (one full, two
   quantized patches), flush; require software recovery == the replica
   bitwise, ``load_state_device`` (K7) == ``load_latest_state``
   bitwise, every recovered value within one quantization step of the
   replica, and K7 launched;
C. phase 3 with ``--compressor packed`` (K8, K9, K10) at the depth of a
   short run: f=4, b=2, resumed at step 3, so 4 steps write a full at
   step 4 and 3 differentials; fail at step 7, recover by device replay
   (bitwise) and by parallel replay (within tolerance); K8 on the run's
   residual as K1 in phase 3;
D. the same with ``--compressor quant8`` (K11, K12, K13; no error
   feedback);
E. the paper's baselines on full-width gpt2-l, dense steps (K3), each
   in its own checkpoint directory: FullSync and CheckFreq (interval 2,
   steps 1-3) recover the step-2 state and Gemini (a host copy every
   step) the step-3 state, bitwise; NaiveDC (rho 0.01, a full at step 3,
   differentials 4 and 5; K1 compresses the 3-Psi delta, K2 decodes it
   in recovery) recovers what the plain versions' decode and pairwise
   merge give, bitwise, and prints its lossy gap; K1, K2 and K3 held
   bitwise against their plain versions on the phase's own leaves; one
   line per strategy (first and later step ms, ``ckpt_time``, bytes,
   recovery ms), then the failure simulator fed the measured constants;
F. gradient accumulation at full width: granite-3-8b (bf16 params,
   grad_accum 2) cut to 4 layers through phase 3's path (f=4, b=2,
   resumed at step 3; device replay bitwise, parallel replay within its
   tolerance; K4 and K2 held on its bf16 leaves), and three dense steps
   of full stablelm-1.6b (K3 held on its leaves);
5. print the ``kernels`` JSON line, the card's name and power limit,
   and the result line.

Exits non-zero without a CUDA device, and when run outside the repo.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
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


def _bound(r) -> None:
    """bound_ms / bound_by of a timing record from its bytes and ops."""
    r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                              r["ops"] / FP32_FLOPS)
    r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                     >= r["ops"] / FP32_FLOPS else "operations")


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
        fn = ""
        for line in build.ptxas_report(name).splitlines():
            m = re.search(r"Function properties for \S*?\d([a-z_]+_kernel)"
                          r"(?:I(\w+?)E+v)?", line)
            if m:               # e.g. topk_select_kernel<fLb1>: f32, K8
                fn = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {fn}: {line.strip()}")
    import torch
    from repro_torch.kernels import span
    grid, cap, smem, per_sm = span.pack_limits(torch.device("cuda", 0))
    log(f"[build] span: pack_one_pass_kernel: {smem} B dynamic shared "
        f"memory per CTA, {per_sm} CTA per SM, cooperative grid {grid}, "
        f"segment capacity {cap} f32")


# ---------------------------------------------------------------- phase 2
def _leaf_shapes(cfg):
    from repro_torch import tree_leaves
    from repro_torch.models import lm
    from repro_torch.models.param import is_spec
    return [tuple(s.shape) for s in tree_leaves(lm.param_specs(cfg),
                                                is_leaf=is_spec)]


#: k values the selection (K1/K8) is checked at: both sides of the
#: 32-lane threshold's limit, the main path's 11, and the extremes
SELECT_KS = (1, 2, 11, 31, 32, 33, 103, 1024)
SELECT_PATHS = ("fast", "tie", "fallback")


def _select_inputs(dev, g):
    """Adversarial inputs of the top-k selection (the CPU test
    ``tests/test_torch_topk_select.py`` builds the same kinds in numpy):
    ties in {-3..3} with an all-zero block, all zeros, signed zeros,
    blocks with exactly 11, exactly 32 and fewer than 11 nonzeros, an
    embedding-like tensor (a few nonzero rows of width 1280 in zeros),
    Student-t with 1 and 3 degrees of freedom, 40 tied maxima per block,
    large values in the columns of ten lanes only, bfloat16 — most with
    a ragged last block."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    ties = torch.randint(-3, 4, (5 * 1024 + 300,), generator=g,
                         device=dev).float()
    ties[1024:2048] = 0.0
    signed = torch.where(randn(2 * 1024 + 77) < 0, -0.0, 0.0)
    signed[1024 + 500] = -2.0
    sparse = torch.zeros(4 * 1024, device=dev)
    for b, nz in enumerate((11, 32, 5, 1)):
        cols = torch.randperm(1024, generator=g, device=dev)[:nz]
        sparse[b * 1024 + cols] = randn(nz)
    embed = torch.zeros((40, 1280), device=dev)
    embed[[3, 17, 18, 39]] = randn(4, 1280)
    chi3 = (randn(3, 3000) ** 2).sum(0) / 3
    tied = randn(3 * 1024 + 11)
    for b in range(3):
        cols = torch.randperm(1024, generator=g, device=dev)[:40]
        tied[b * 1024 + cols] = 5.0 * (-1.0) ** b
    # large values only in the columns of lanes 0-9 (f32 layout): more
    # than 32 elements above the 11th lane maximum
    lanes = randn(2 * 1024 + 600)
    lanes[torch.arange(lanes.numel(), device=dev) % 128 < 40] *= 1000.0
    return [("ties", ties), ("zeros", torch.zeros(3 * 1024 + 5, device=dev)),
            ("signed zeros", signed), ("k nonzeros", sparse),
            ("embedding", embed), ("student-t1", randn(2500) / randn(2500)),
            ("student-t3", randn(3000) / chi3.sqrt()), ("tied maxima", tied),
            ("ten lanes", lanes),
            ("bf16", randn(3000).to(torch.bfloat16)),
            ("bf16 embedding", embed.to(torch.bfloat16))]


def _path_shares(xs, k):
    """Share of the 1024-blocks of the tensors ``xs`` that K1/K8's
    selection (``csrc/topk.cu``) takes through each path, by the kernel's
    own rule computed here in torch: lane l of a block holds the columns
    j * 32 * VEC + l * VEC + e (VEC = 16 bytes / element size), t0 is the
    k-th largest of the 32 lane maxima of |x|; "fast" if at most 32
    elements have |x| >= t0, else "tie" if at most 32 have |x| > t0,
    else (and whenever k > 32) "fallback"."""
    from repro_torch.kernels import ref
    counts = dict.fromkeys(SELECT_PATHS, 0)
    for x in xs:
        vec = 16 // x.element_size()
        xb = ref.to_blocks(x, 1024)[0]
        for c0 in range(0, xb.shape[0], 1 << 16):
            mag = xb[c0:c0 + (1 << 16)].float().abs()
            m = mag.shape[0]
            if k > 32:
                counts["fallback"] += m
                continue
            lane_max = mag.view(m, 1024 // (32 * vec), 32, vec).amax(
                dim=(1, 3))
            t0 = lane_max.topk(k, dim=1).values[:, k - 1:]
            fast = (mag >= t0).sum(1) <= 32
            tie = ~fast & ((mag > t0).sum(1) <= 32)
            counts["fast"] += int(fast.sum())
            counts["tie"] += int(tie.sum())
            counts["fallback"] += m - int(fast.sum()) - int(tie.sum())
    total = sum(counts.values())
    return {p: c / total for p, c in counts.items()}


def _fmt_shares(shares) -> str:
    return " ".join(f"{p}={shares[p]:.6f}" for p in SELECT_PATHS)


def _edge_cases(dev, err):
    """Small inputs that exercise ties, zero blocks, ragged tails, k
    extremes and bfloat16 — exact/bitwise against the plain versions;
    then K1/K2 on the selection's adversarial inputs at every k of
    ``SELECT_KS``. Raises each kernel's entry of ``err`` to its largest
    |kernel - plain|."""
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
    sel = _select_inputs(dev, g)
    for name, x in sel:
        for k in SELECT_KS:
            v, i = topk.topk_select(x, k)
            rv, ri = ref.topk_select_ref(ref.to_blocks(x, 1024)[0], k)
            err["topk_select"] = max(err["topk_select"], abs_err(v, rv),
                                     abs_err(i, ri))
            if not (torch.equal(i, ri) and bits_equal(v, rv)):
                fail(f"K1 on {name} {tuple(x.shape)} k={k}")
            d = topk.topk_scatter(v, i, x.numel())
            rd = ref.topk_scatter_ref(rv, ri, 1024).reshape(-1)[:x.numel()]
            err["topk_scatter"] = max(err["topk_scatter"], abs_err(d, rd))
            if not bits_equal(d, rd):
                fail(f"K2 on {name} {tuple(x.shape)} k={k}")
            n_checks += 2
    log(f"[parity] edge cases: {n_checks} kernel/plain comparisons equal")
    for k in (11, 32):
        log(f"[paths] K1 edge cases k={k}: "
            f"{_fmt_shares(_path_shares([x for _, x in sel], k))}")


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
    # what the selection costs per k: k = 1 is the load with one pick,
    # the slope to k = 32 what each further pick adds
    diag = {kk: timed(lambda kk=kk: [topk.topk_select(x, kk) for x in xs],
                      reps) for kk in (1, 11, 32)}
    log("[diagnose] K1 topk_select over one step's leaves: "
        + " ".join(f"k={kk}: {t:.4f} ms" for kk, t in diag.items())
        + f"; slope (k=32 - k=1) / 31 = {(diag[32] - diag[1]) / 31:.4f} "
        f"ms per pick")
    for kk in (k, 32):
        log(f"[paths] K1 random leaves k={kk}: "
            f"{_fmt_shares(_path_shares(xs, kk))}")
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
    # the library call makes the dense tensor K2 makes: a zero fill of
    # every block, then the scatter (the int64 indices scatter_ takes are
    # converted once, outside the timed calls)
    i64 = [i.long() for _, i in outs]
    lib = timed(lambda: [torch.zeros((nb, 1024), device=dev).scatter_(1, i, v)
                         for nb, i, (v, _) in zip(nbs, i64, outs)], reps)
    del i64
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
        _bound(r)
        log(f"[timing] {name}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"library_ms={r['library_ms']} max_abs_err={r['max_abs_err']} "
            f"(one step's leaves, "
            f"{r['bytes'] / 1e9:.3f} GB)")
    return res


# ------------------------------------------------- phase 2, K8-K13
def _compressor_checks(err, x, k, p, mu, nu, hyper):
    """K8-K13 on one input ``x`` (any shape) against their plain
    versions, bitwise; K8's indices also against K1's. The apply kernels
    update state (p, mu, nu), p in its own dtype. Raises ``err``'s
    entries to the largest |kernel - plain|; returns the K8 and K11
    payloads."""
    import torch
    from repro_torch.kernels import pack, quant8, ref, replay, topk
    what = f"{tuple(x.shape)} {x.dtype} k={k} p {p.dtype}"
    xb = ref.to_blocks(x, 1024)[0]
    blocks = [ref.to_blocks(t, 1024)[0] for t in (p, mu, nu)]

    def same(name, got, want):
        err[name] = max([err[name]] + [abs_err(a, b)
                                       for a, b in zip(got, want)])
        if not all(bits_equal(a, b) for a, b in zip(got, want)):
            fail(f"{name} != plain version on {what}")

    q, i, s = pack.pack_select(x, k)
    same("pack_select", (q, i, s), ref.pack_select_ref(xb, k))
    if not torch.equal(i, topk.topk_select(x, k)[1]):
        fail(f"K8 indices != K1 indices on {what}")
    n = x.numel()
    same("pack_scatter", (pack.pack_scatter(q, i, s, n),),
         (ref.pack_scatter_ref(q, i, s, 1024).reshape(-1)[:n],))
    for kk in {k, 0}:                         # k == 0: g == 0 exactly
        qq, ii = q[:, :kk].contiguous(), i[:, :kk].contiguous()
        same("packed_apply", replay.packed_apply(qq, ii, s, p, mu, nu, hyper),
             [ref.unblock(t, p.shape) for t in ref.packed_apply_ref(
                 qq, ii, s, *blocks, hyper, block=1024)])
    q8, s8 = quant8.quantize(x)
    rq, rs = ref.quantize_ref(xb)
    same("quantize", (q8, s8), (rq, rs.reshape(-1)))
    same("dequantize", (quant8.dequantize(q8, s8, n),),
         (ref.dequantize_ref(q8, s8).reshape(-1)[:n],))
    same("quant_apply", replay.quant_apply(q8, s8, p, mu, nu, hyper),
         [ref.unblock(t, p.shape) for t in ref.quant_apply_ref(
             q8, s8, *blocks, hyper)])
    return (q, i, s), (q8, s8)


def phase_compressors(cfg, dev, reps: int = REPS):
    """Phase 2 for K8-K13 (the packed and quant8 compressors): bitwise
    against the plain versions on edge cases and on every full-width
    gpt2-l leaf as 1024-blocks, then timed over one step's worth of
    leaves (k = 11 for K8-K10)."""
    import torch
    from repro_torch.compression.sparse import k_for
    from repro_torch.kernels import pack, quant8, ref, replay
    from repro_torch.kernels.ops import adam_hyper_traced
    names = ("pack_select", "pack_scatter", "packed_apply", "quantize",
             "dequantize", "quant_apply")
    err = {k: 0.0 for k in names}
    hyper = adam_hyper_traced(1e-3, 0.9, 0.999, 1e-8,
                              torch.tensor(3, dtype=torch.int32, device=dev))
    g = torch.Generator(device=dev).manual_seed(13)
    # edge cases: ties and an all-zero block, a ragged last block, values
    # whose x / scale lands on the half steps, bf16 inputs and params
    ties = torch.randint(-3, 4, (5 * 1024 + 300,), generator=g,
                         device=dev).float()
    ties[1024:2048] = 0.0
    half = torch.randn(3 * 1024 + 7, generator=g, device=dev)
    half[:1024] = torch.arange(1024, device=dev) % 254 - 126.5
    half[0] = 127.0
    cases = [ties, half, torch.randn(2500, generator=g, device=dev),
             torch.randn(3000, generator=g, device=dev).to(torch.bfloat16)]
    n_checks = 0
    for x in cases:
        for k in (1, 11, 103):
            for pdt in (torch.float32, torch.bfloat16):
                p = torch.randn(x.shape, generator=g, device=dev).to(pdt)
                mu = torch.randn(x.shape, generator=g, device=dev) * 0.1
                nu = torch.rand(x.shape, generator=g, device=dev) * 0.01
                _compressor_checks(err, x, k, p, mu, nu, hyper)
                n_checks += 8
    for _, x in _select_inputs(dev, g):       # the selection's adversaries
        for k in SELECT_KS:
            p = torch.randn(x.shape, generator=g, device=dev)
            mu = torch.randn(x.shape, generator=g, device=dev) * 0.1
            nu = torch.rand(x.shape, generator=g, device=dev) * 0.01
            _compressor_checks(err, x, k, p, mu, nu, hyper)
            n_checks += 8
    zq, _, zs = pack.pack_select(ties, 11)
    z8, zs8 = quant8.quantize(ties)
    if not (float(zs[1, 0]) == float(zs8[1]) == float(torch.tensor(1e-12))
            and not zq[1].any() and not z8[1].any()):
        fail("an all-zero block must give scale 1e-12 and codes 0")
    log(f"[parity] K8-K13 edge cases: {n_checks} kernel/plain comparisons "
        f"bitwise equal")

    shapes = _leaf_shapes(cfg)
    n_all = sum(math.prod(s) for s in shapes)
    nb_all = sum(-(-math.prod(s) // 1024) for s in shapes)
    k = k_for(0.01)
    xs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    mus = [torch.randn(s, generator=g, device=dev) * 0.1 for s in shapes]
    nus = [torch.rand(s, generator=g, device=dev) * 0.01 for s in shapes]
    outs = [_compressor_checks(err, x, k, x, mu, nu, hyper)
            for x, mu, nu in zip(xs, mus, nus)]
    torch.cuda.empty_cache()
    log("[parity] K8-K13: bitwise equal to the plain versions on every "
        "leaf (K8 indices == K1 indices)")
    log(f"[paths] K8 random leaves k={k}: {_fmt_shares(_path_shares(xs, k))}")
    packs = [o[0] for o in outs]
    q8s = [o[1] for o in outs]
    ns = [x.numel() for x in xs]
    state = list(zip(xs, mus, nus))
    slow = max(1, reps // 5)
    res = {}
    res["pack_select"] = dict(
        ms=timed(lambda: [pack.pack_select(x, k) for x in xs], reps),
        plain_ms=timed(lambda: [ref.pack_select_ref(
            ref.to_blocks(x, 1024)[0], k) for x in xs], slow),
        library_ms=None, bytes=4 * n_all + (5 * k + 4) * nb_all,
        ops=2 * k * 1024 * nb_all)
    res["pack_scatter"] = dict(
        ms=timed(lambda: [pack.pack_scatter(q, i, s, n)
                          for (q, i, s), n in zip(packs, ns)], reps),
        plain_ms=timed(lambda: [ref.pack_scatter_ref(q, i, s, 1024)
                                for q, i, s in packs], slow),
        library_ms=None, bytes=4 * n_all + (5 * k + 4) * nb_all,
        ops=2 * k * nb_all)

    def plain_apply(fn, payloads):
        for pay, (p, mu, nu) in zip(payloads, state):
            fn(*pay, *(ref.to_blocks(t, 1024)[0] for t in (p, mu, nu)))
    res["packed_apply"] = dict(
        ms=timed(lambda: [replay.packed_apply(*pay, *st, hyper)
                          for pay, st in zip(packs, state)], reps),
        plain_ms=timed(lambda: plain_apply(
            lambda q, i, s, p, mu, nu: ref.packed_apply_ref(
                q, i, s, p, mu, nu, hyper, block=1024), packs), slow),
        library_ms=None, bytes=24 * n_all + (5 * k + 4) * nb_all,
        ops=13 * n_all + 2 * k * nb_all)
    res["quantize"] = dict(
        ms=timed(lambda: [quant8.quantize(x) for x in xs], reps),
        plain_ms=timed(lambda: [ref.quantize_ref(ref.to_blocks(x, 1024)[0])
                                for x in xs], slow),
        library_ms=None, bytes=4 * n_all + (1024 + 4) * nb_all,
        ops=5 * 1024 * nb_all)
    s2 = [s.reshape(-1, 1) for _, s in q8s]
    res["dequantize"] = dict(
        ms=timed(lambda: [quant8.dequantize(q, s, n)
                          for (q, s), n in zip(q8s, ns)], reps),
        plain_ms=timed(lambda: [ref.dequantize_ref(q, s) for q, s in q8s],
                       slow),
        library_ms=timed(lambda: [torch.mul(q, s) for (q, _), s
                                  in zip(q8s, s2)], reps),
        bytes=4 * n_all + (1024 + 4) * nb_all, ops=n_all)
    res["quant_apply"] = dict(
        ms=timed(lambda: [replay.quant_apply(*pay, *st, hyper)
                          for pay, st in zip(q8s, state)], reps),
        plain_ms=timed(lambda: plain_apply(
            lambda q, s, p, mu, nu: ref.quant_apply_ref(
                q, s, p, mu, nu, hyper), q8s), slow),
        library_ms=None, bytes=24 * n_all + (1024 + 4) * nb_all,
        ops=14 * n_all)
    del xs, mus, nus, outs, packs, q8s, state, s2
    torch.cuda.empty_cache()
    for name, r in res.items():
        r["max_abs_err"] = err[name]
        _bound(r)
        log(f"[timing] {name}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"library_ms={r['library_ms']} max_abs_err={r['max_abs_err']} "
            f"(one step's leaves, {r['bytes'] / 1e9:.3f} GB)")
    return res


# ---------------------------------------------------------------- phase A
def _span_edge_cases(dev, err):
    """K5-K7 on small inputs against the plain versions, bitwise: cols 1
    and odd, n 1 and 9, all-zero rows, a row whose absmax lies in its
    last column block, start > 0, a span ending at the last row, a bf16
    and a tail-shaped leaf."""
    import torch
    from repro_torch.kernels import ref, span
    g = torch.Generator(device=dev).manual_seed(11)
    n_checks = 0
    for n, cols in ((1, 1), (9, 1), (1, 7), (9, 7), (9, 1281), (3, 20001)):
        x = torch.randn((n, cols), generator=g, device=dev)
        x[0] = 0.0
        if cols > 16384:
            x[-1, -1] = 50.0            # absmax in the row's last block
        for bits in (8, 4):
            q, s = span.span_pack(x, bits)
            rq, rs = ref.span_pack_ref(x, bits)
            err["span_pack"] = max(err["span_pack"], abs_err(q, rq),
                                   abs_err(s, rs))
            if not (torch.equal(q, rq) and bits_equal(s, rs)):
                fail(f"K5 edge case n={n} cols={cols} int{bits}")
            d = span.quant_span_decode(q, s, cols, bits)
            rd = ref.span_decode_ref(q, s, cols, bits)
            err["quant_span_decode"] = max(err["quant_span_decode"],
                                           abs_err(d, rd))
            if not bits_equal(d, rd):
                fail(f"K6 edge case n={n} cols={cols} int{bits}")
            for shape, dt in (((n + 4, cols), torch.float32),
                              ((n + 4, cols), torch.bfloat16),
                              ((n + 2,) + ((cols,) if cols < 3 else
                                           (1, cols)), torch.float32)):
                base = torch.randn(shape, generator=g, device=dev).to(dt)
                start = shape[0] - n          # the span ends at the last row
                got = span.quant_span_apply(q, s, base.clone(), start, bits)
                want = ref.quant_span_apply_ref(q, s, base.clone(), start,
                                                bits=bits)
                err["quant_span_apply"] = max(err["quant_span_apply"],
                                              abs_err(got, want))
                if not bits_equal(got, want):
                    fail(f"K7 edge case n={n} cols={cols} int{bits} "
                         f"{dt} {shape} start={start}")
            n_checks += 5
    # values on and a few ulps around (k + 1/2) * scale: the rounding
    # mode and a true division (not a reciprocal multiply) decide them
    import numpy as np
    from repro_torch.compression.quant_span import encode_rows
    rng = np.random.default_rng(0)
    for bits, qmax in ((8, 127.0), (4, 7.0)):
        rows = []
        for _ in range(16):
            amax = np.float32(rng.uniform(0.1, 10.0))
            sc = amax * np.float32(1.0 / qmax)
            vals = [amax]
            for k in range(-int(qmax), int(qmax)):
                up = dn = np.float32((k + 0.5) * sc)
                vals.append(up)
                for _ in range(3):
                    up = np.nextafter(up, np.float32(np.inf))
                    dn = np.nextafter(dn, np.float32(-np.inf))
                    vals += [up, dn]
            rows.append(vals)
        xn = np.asarray(rows, np.float32)
        q, s = span.span_pack(torch.from_numpy(xn).to(dev), bits)
        nq, ns = encode_rows(xn, bits)
        if not (np.array_equal(q.cpu().numpy(), nq) and np.array_equal(
                s.cpu().numpy().view(np.int32), ns.view(np.int32))):
            fail(f"K5 int{bits} != encode_rows at half steps")
        n_checks += 1
    # a row wider than the grid's shared memory: the two-pass path
    grid, cap = span.pack_limits(dev)[:2]
    wide = max(9_000_000, grid * cap + 1)
    x = torch.randn((1, wide), generator=g, device=dev)
    x[0, -1] = 60.0
    xn = x.cpu().numpy()
    before = span.PATHS["two_pass"][0]
    for bits in (8, 4):
        q, s = span.span_pack(x, bits)
        rq, rs = ref.span_pack_ref(x, bits)
        err["span_pack"] = max(err["span_pack"], abs_err(q, rq),
                               abs_err(s, rs))
        nq, ns = encode_rows(xn, bits)
        if not (torch.equal(q, rq) and bits_equal(s, rs)
                and np.array_equal(q.cpu().numpy(), nq) and np.array_equal(
                    s.cpu().numpy().view(np.int32), ns.view(np.int32))):
            fail(f"K5 int{bits} on a 1x{wide} row (two-pass path)")
        n_checks += 2
    if span.PATHS["two_pass"][0] != before + 2:
        fail(f"a 1x{wide} row did not take K5's two-pass path")
    log(f"[span] a 1x{wide} row (> grid {grid} x {cap} f32): two-pass "
        f"path, int8 and int4 bitwise equal to plain and encode_rows")
    log(f"[span] edge cases: {n_checks} kernel/plain (or kernel/numpy) "
        f"comparisons bitwise equal")


def phase_span(cfg, dev, reps: int = REPS):
    """Phase A: K5-K7 against their plain versions, bitwise, on every
    gpt2-l leaf as the LowDiff+ replica quantizes it ((rows, prod(tail)),
    int8 and int4), K5/K6 also against the numpy codec on a row slice of
    each leaf; then timed over one step's worth of rows."""
    import numpy as np
    import torch
    from repro_torch.compression.quant_span import decode_rows, encode_rows
    from repro_torch.kernels import ref, span
    err = {k: 0.0 for k in ("span_pack", "quant_span_decode",
                            "quant_span_apply")}
    span.reset_paths()
    _span_edge_cases(dev, err)
    shapes = [(s[0], math.prod(s[1:])) for s in _leaf_shapes(cfg)]
    n_all = sum(r * c for r, c in shapes)
    rows_all = sum(r for r, _ in shapes)
    log(f"[span] gpt2-l leaves as row blocks: {shapes}")
    grid, cap = span.pack_limits(dev)[:2]
    for r, c in sorted(set(shapes)):
        p = span.pack_plan(r, c, grid, cap)
        log(f"[span] K5 plan {r}x{c}: " + (
            f"two_pass (a row is wider than {grid} x {cap} f32)"
            if p.path == "two_pass" else
            f"one_pass grid={p.grid} "
            + (f"{p.rows} rows of {c} f32 per segment, one row to a warp"
               if p.warp_rows else
               f"{p.parts} part(s) of {p.width} f32 per row")
            + f", {p.segments} segments, {p.waves} waves"))
    g = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    for x in xs:
        x[0, : min(x.shape[1], 3)] = 0.0
        x[-1] = 0.0                      # an all-zero row in every leaf
    numpy_elems = 0
    for bits in (8, 4):
        for x in xs:
            n, cols = x.shape
            q, s = span.span_pack(x, bits)
            rq, rs = ref.span_pack_ref(x, bits)
            err["span_pack"] = max(err["span_pack"], abs_err(q, rq),
                                   abs_err(s, rs))
            if not (torch.equal(q, rq) and bits_equal(s, rs)):
                fail(f"K5 span_pack int{bits} != plain version on {n}x{cols}")
            del rq, rs
            d = span.quant_span_decode(q, s, cols, bits)
            rd = ref.span_decode_ref(q, s, cols, bits)
            err["quant_span_decode"] = max(err["quant_span_decode"],
                                           abs_err(d, rd))
            if not bits_equal(d, rd):
                fail(f"K6 quant_span_decode int{bits} != plain version on "
                     f"{n}x{cols}")
            del rd
            dst = torch.randn((n + 3, cols), generator=g, device=dev)
            got = span.quant_span_apply(q, s, dst.clone(), 3, bits)
            want = ref.quant_span_apply_ref(q, s, dst, 3, bits=bits)
            err["quant_span_apply"] = max(err["quant_span_apply"],
                                          abs_err(got, want))
            if not bits_equal(got, want):
                fail(f"K7 quant_span_apply int{bits} != plain version on "
                     f"{n}x{cols}")
            del got, want, dst
            # the numpy codec on a slice of rows (per-row quantization:
            # a slice's bytes are the whole leaf's rows)
            r = max(1, min(n, (1 << 22) // cols))
            xn = x[:r].cpu().numpy()
            nq, ns = encode_rows(xn, bits)
            if not (np.array_equal(q[:r].cpu().numpy(), nq) and np.array_equal(
                    s[:r].cpu().numpy().view(np.int32), ns.view(np.int32))):
                fail(f"K5 int{bits} != encode_rows on {r}x{cols}")
            nd = decode_rows(nq, ns, cols, bits)
            if not np.array_equal(d[:r].cpu().numpy().view(np.int32),
                                  nd.view(np.int32)):
                fail(f"K6 int{bits} != decode_rows on {r}x{cols}")
            numpy_elems += r * cols
            del q, s, d
        log(f"[span] int{bits}: K5/K6/K7 bitwise equal to the plain "
            f"versions on every leaf")
    log(f"[span] K5/K6 equal to encode_rows/decode_rows on "
        f"{numpy_elems} elements (a row slice of every leaf, both widths)")
    from repro_torch.kernels import build
    parity_launches = dict(build.LAUNCHES)
    log(f"[paths] span_pack phase A checks: {_fmt_span_paths()}")

    res = {}
    packed = [span.span_pack(x, 8) for x in xs]
    span.reset_paths()
    # no single PyTorch call computes K5 (per-row absmax, division,
    # rounding, clipping, nibble packing): library_ms stays None
    res["span_pack"] = dict(
        ms=timed(lambda: [span.span_pack(x, 8) for x in xs], reps),
        plain_ms=timed(lambda: [ref.span_pack_ref(x, 8) for x in xs],
                       max(1, reps // 5)),
        library_ms=None, bytes=5 * n_all + 4 * rows_all, ops=4 * n_all)
    log(f"[paths] span_pack timed set (int8, {reps + 1} passes): "
        f"{_fmt_span_paths()}")
    int4 = dict(ms=timed(lambda: [span.span_pack(x, 4) for x in xs], reps),
                bytes=sum(r * (4 * c + (c + 1) // 2 + 4) for r, c in shapes),
                ops=4 * n_all)
    _bound(int4)
    log(f"[timing] span_pack int4: kernel_ms={int4['ms']:.4f} "
        f"bound_ms={int4['bound_ms']:.4f} ({int4['bytes'] / 1e9:.3f} GB, "
        f"{100 * int4['bound_ms'] / int4['ms']:.1f}% of bound)")
    for shp in sorted(set(shapes)):        # where K5's time goes
        group = [x for x in xs if tuple(x.shape) == shp]
        ms = timed(lambda: [span.span_pack(x, 8) for x in group], reps)
        bound = 1e3 * len(group) * shp[0] * (5 * shp[1] + 4) / HBM_BYTES_PER_S
        log(f"[span] K5 int8 {len(group)} x {shp[0]}x{shp[1]}: "
            f"{ms:.4f} ms, bound {bound:.4f} ms "
            f"({100 * bound / ms:.1f}% of bound)")
    for shp in sorted(set(shapes)):        # the kernel's phases per wave
        plan = span.pack_plan(shp[0], shp[1], grid, cap)
        if plan.path == "one_pass":
            x = next(x for x in xs if tuple(x.shape) == shp)
            span.pack_phases(x, 8)
            log(f"[span] K5 int8 phases {shp[0]}x{shp[1]}: "
                + _fmt_phases(span.pack_phases(x, 8)[2].cpu(), plan.grid))
    del xs
    # K6's yardstick: an int8 row block decodes with one call, q * scale
    q0, s0 = packed[0]
    if not bits_equal(torch.mul(q0, s0),
                      span.quant_span_decode(q0, s0, q0.shape[1], 8)):
        fail("torch.mul(q, scale) != K6 on an int8 leaf")
    res["quant_span_decode"] = dict(
        ms=timed(lambda: [span.quant_span_decode(q, s, q.shape[1], 8)
                          for q, s in packed], reps),
        plain_ms=timed(lambda: [ref.span_decode_ref(q, s, q.shape[1], 8)
                                for q, s in packed], max(1, reps // 5)),
        library_ms=timed(lambda: [torch.mul(q, s) for q, s in packed],
                         reps),
        bytes=5 * n_all + 4 * rows_all, ops=n_all)
    # K7 over one int4 full-state patch: params int4, moments int8 (no
    # single PyTorch call decodes int4 nibbles: library_ms stays None)
    patch, dsts = [], []
    for (q8, s8), (r, c) in zip(packed, shapes):
        x = torch.randn((r, c), generator=g, device=dev)
        patch.append((span.span_pack(x, 4), (q8, s8), (q8, s8)))
        dsts.append([torch.empty((r, c), device=dev) for _ in range(3)])
    del x

    def apply_patch(fn):
        for comps, ds in zip(patch, dsts):
            for (q, s), d, bits in zip(comps, ds, (4, 8, 8)):
                fn(q, s, d, 0, bits)
    res["quant_span_apply"] = dict(
        ms=timed(lambda: apply_patch(span.quant_span_apply), reps),
        plain_ms=timed(lambda: apply_patch(
            lambda q, s, d, st, b: ref.quant_span_apply_ref(q, s, d, st,
                                                            bits=b)),
            max(1, reps // 5)),
        library_ms=None, bytes=(n_all // 2 + 2 * n_all + 12 * rows_all
                                + 12 * n_all),
        ops=3 * n_all)
    del packed, patch, dsts
    torch.cuda.empty_cache()
    for name, r in res.items():
        r["max_abs_err"] = err[name]
        r["parity_launches"] = parity_launches[name]
        _bound(r)
        log(f"[timing] {name}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"library_ms={r['library_ms']} max_abs_err={r['max_abs_err']} "
            f"({r['bytes'] / 1e9:.3f} GB)")
    return res


def _fmt_phases(t, grid: int) -> str:
    """Means over a launch's waves (a wave: ``grid`` consecutive
    segments, one per CTA) of the kernel's phase times (``pack_phases``
    stamps, ns): the wave's span from its first start to its last end;
    per segment the load (start to copies landed), the sync (to the
    row's absmax) and the quantize (to the bytes written), each as the
    mean over the wave's CTAs and the slowest one."""
    t = t.double() / 1e3                            # us
    waves = -(-t.shape[0] // grid)
    pad = waves * grid - t.shape[0]
    t = _pad_rows(t, pad).reshape(waves, grid, 4)
    span_us = (t[..., 3].nan_to_num(-1e30).amax(1)
               - t[..., 0].nan_to_num(1e30).amin(1)).mean()
    out = [f"{waves} waves, {float(span_us):.2f} us a wave"]
    for name, a, b in (("load", 0, 1), ("sync", 1, 2), ("quantize", 2, 3)):
        d = t[..., b] - t[..., a]
        mean = d.nanmean(1).mean()
        slow = d.nan_to_num(-1e30).amax(1).mean()
        out.append(f"{name} {float(mean):.2f} (slowest {float(slow):.2f})")
    return "; ".join(out) + " us"


def _pad_rows(t, pad: int):
    import torch
    if not pad:
        return t
    return torch.cat([t, torch.full((pad, 4), float("nan"),
                                    dtype=t.dtype)])


def _fmt_span_paths() -> str:
    from repro_torch.kernels import span
    return " ".join(f"{p}: rows={v[0]} elements={v[1]}"
                    for p, v in span.PATHS.items())


# ---------------------------------------------------------------- phase 3
def _small_reference_check(dev, compressor: str = "topk", cfg=None):
    """``cfg``'s arch reduced, with its ``grad_accum`` kept (gpt2-l by
    default): one lowdiff step on the card (kernels) against the same
    step on the CPU (plain versions), from the same params/batch. The
    gradients round differently on the two devices, so a near-tie may
    flip a top-k pick or an int8 code: >= 99.9% must agree."""
    import torch
    from repro_torch import tree_leaves
    from repro_torch.compression.sparse import is_compressed
    from repro_torch.configs import get_config
    from repro_torch.core.steps import init_state, make_train_step
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.registry import build_model
    full = get_config("gpt2-l") if cfg is None else cfg
    cfg = get_config(full.name).reduced().replace(grad_accum=full.grad_accum)
    model = build_model(cfg)
    cpu = init_state(model, 0, device="cpu")
    gpu = init_state(model, 0, device=dev, params={
        k: v for k, v in _to(cpu["params"], dev).items()})
    step = make_train_step(model, compressor=compressor)
    b = make_batch(cfg, 64, 2, step=0)
    s_cpu, m_cpu, cg_cpu = step(cpu, b)
    s_gpu, m_gpu, cg_gpu = step(gpu, {k: v.to(dev) for k, v in b.items()})
    lc, lg = float(m_cpu["loss"]), float(m_gpu["loss"])
    if not (math.isfinite(lg) and abs(lc - lg) <= 1e-4 * abs(lc)):
        fail(f"reduced-step loss card {lg} vs cpu {lc}")
    agree = tot = 0
    what = "int8 codes" if compressor == "quant8" else "top-k rows"
    for a, b_ in zip(tree_leaves(cg_cpu, is_leaf=is_compressed),
                     tree_leaves(cg_gpu, is_leaf=is_compressed)):
        if compressor == "quant8":
            same = a.q == b_.q.cpu()
        else:
            same = (a.indices == b_.indices.cpu()).all(dim=1)
        agree += int(same.sum())
        tot += same.numel()
    if agree < 0.999 * tot:
        fail(f"reduced {compressor} step: {what} agree {agree}/{tot}")
    log(f"[reference] reduced {cfg.name} (grad_accum {cfg.grad_accum}) "
        f"{compressor} step card vs cpu: loss {lg:.6f} vs {lc:.6f}, {what} "
        f"agree {agree}/{tot}")


def _to(tree, dev):
    from repro_torch import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def _replay_close(got, want, n: int, lr: float = 1e-3) -> float:
    """Largest |got - want| / (atol + rtol |want|) over the elements of
    every leaf, with the CPU tests' tolerance for parallel replay (rtol
    1e-5, atol 1e-6 of the leaf's largest magnitude, at least 1e-6):
    reassociated sums of the window's Adam steps. A bf16 leaf (params of
    a bf16 config) also rounds differently: serial replay rounds each of
    the ``n`` steps to bf16, parallel replay rounds their sum once, each
    rounding within half an ulp (<= 2^-8 of the value) at the largest
    magnitude the chain reaches, at most the two ends plus n Adam steps
    of <= 4 lr; so atol grows by (n + 1) 2^-8 (max(|got|, |want|) +
    4 n lr). Integer leaves must be equal (ratio 0, else inf)."""
    import torch
    worst = 0.0
    for a, b in zip(got, want):
        if not b.is_floating_point():
            if not torch.equal(a, b):
                return math.inf
            continue
        bf16 = b.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        atol = 1e-6 * max(1.0, float(b.abs().max()))
        if bf16:
            atol = atol + (n + 1) * 2.0 ** -8 * (
                torch.maximum(a.abs(), b.abs()) + 4 * n * lr)
        worst = max(worst, float(((a - b).abs()
                                  / (atol + 1e-5 * b.abs())).max()))
    return worst


def _residual_check(state, compressor: str, reps: int = REPS):
    """K1 (``topk``) or K8 (``packed``) on the run's own error-feedback
    residual ``state["ef"]`` (its 12 leaves keep the rows of the
    embedding that no token of the run touched at zero, which random
    leaves lack): bitwise against the plain version (K8's indices also
    against K1's), timed, with the share of blocks on each selection
    path. Its launches are measurement, not the path's: the counts are
    put back as they were."""
    import torch
    from repro_torch import tree_leaves
    from repro_torch.compression.sparse import k_for
    from repro_torch.kernels import build, pack, ref, topk
    counts = dict(build.LAUNCHES)
    xs = tree_leaves(state["ef"])
    k = k_for(0.01)
    name, fn, plain = (("K1 topk_select", topk.topk_select,
                        ref.topk_select_ref) if compressor == "topk" else
                       ("K8 pack_select", pack.pack_select,
                        ref.pack_select_ref))
    for x in xs:
        got = fn(x, k)
        want = plain(ref.to_blocks(x, 1024)[0], k)
        if not all(bits_equal(a, b) for a, b in zip(got, want)):
            fail(f"{name} != plain version on the residual leaf "
                 f"{tuple(x.shape)}")
        if compressor == "packed" and not torch.equal(
                got[1], topk.topk_select(x, k)[1]):
            fail(f"K8 indices != K1 indices on the residual leaf "
                 f"{tuple(x.shape)}")
        del got, want
    ms = timed(lambda: [fn(x, k) for x in xs], reps)
    nb = sum(-(-x.numel() // 1024) for x in xs)
    zero = sum(int((ref.to_blocks(x, 1024)[0] == 0).all(1).sum())
               for x in xs)
    log(f"[residual] {name} on this run's EF residual ({len(xs)} leaves, {nb} "
        f"blocks, {zero} all-zero): bitwise equal to the plain version; "
        f"kernel_ms={ms:.4f}")
    log(f"[paths] {name} EF residual k={k}: "
        f"{_fmt_shares(_path_shares(xs, k))}")
    build.LAUNCHES.update(counts)
    torch.cuda.empty_cache()


#: kernels each compressor's training and recovery must launch
PATH_KERNELS = {"topk": ("topk_select", "topk_scatter", "topk_apply"),
                "packed": ("pack_select", "pack_scatter", "packed_apply"),
                "quant8": ("quantize", "dequantize", "quant_apply")}


def phase_main(cfg, dev, ckdir: str, compressor: str = "topk",
               steps: int = 20, start: int = 19, full_interval: int = 20,
               tag: str = ""):
    """LowDiff with ``compressor`` on the model of ``cfg`` (full width;
    gpt2-l in phases 3, C, D, granite in phase F), resumed at step
    ``start``: ``steps`` steps write a full at the first multiple of
    ``full_interval`` and the differentials after it; then fail, recover
    by device replay (bitwise) and by parallel replay (within the
    reassociation tolerance), and require the compressor's kernels to
    have launched. With top-k, K4 and K2 are also held against their
    plain versions on the last step's own leaves and payload. Returns (launch counts of this run, payload bytes of the
    last step)."""
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
    tag = tag or ("[main]" if compressor == "topk" else f"[{compressor}]")
    _small_reference_check(dev, compressor, cfg)
    shutil.rmtree(ckdir, ignore_errors=True)
    model = build_model(cfg)
    fail_at = start + steps
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{model.n_params()} params; LowDiff {compressor} rho=0.01"
        f"{'' if compressor == 'quant8' else ' + EF'}, f={full_interval}, "
        f"b=2, batch 4 x seq 64, steps {start + 1}..{fail_at}, device "
        f"replay then parallel replay")
    TRACER.clear()
    TRACER.enable()
    store = CheckpointStore(ckdir)
    strat = LowDiff(model, store, rho=0.01, lr=1e-3,
                    full_interval=full_interval, batch_size=2,
                    compressor=compressor, replay_device=True, device=dev,
                    flush_timeout=3600.0)
    state = init_state(model, 0, device=dev)
    state["step"] = torch.tensor(start, dtype=torch.int32, device=dev)
    stream = TokenStream(cfg, 64, 4, seed=0, device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    step_ms, losses, diff_bytes, last = [], [], [], []
    orig_step = strat.step_fn

    def step_fn(st, b):             # records each step's payload size
        out = orig_step(st, b)
        diff_bytes.append(tree_nbytes(out[2]))
        if compressor == "topk" and len(diff_bytes) == steps:
            last[:] = [st, out[2]]  # and the last step's inputs
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
    log(f"{tag} step_ms={[round(s, 3) for s in step_ms]} "
        f"losses={[round(l, 5) for l in losses]}")
    log(f"{tag} differential bytes per step: {diff_bytes[-1]} "
        f"(dense f32 gradient {4 * model.n_params()})")
    if last:
        _lowdiff_kernel_checks(*last, state, tag)
        del last[:]
    trained = [t.clone() for t in tree_leaves(state["params"])
               + tree_leaves(state["opt"])]
    t0 = time.perf_counter()
    strat.flush()
    flush_s = time.perf_counter() - t0
    if compressor in ("topk", "packed"):
        _residual_check(state, compressor)
    log(f"*** injected failure at step {fail_at} ***")
    del state
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, applied = strat.recover()
    torch.cuda.synchronize()
    rec_ms = (time.perf_counter() - t0) * 1e3
    rec_peak = torch.cuda.max_memory_allocated(dev) - base
    recovered = tree_leaves(state["params"]) + tree_leaves(state["opt"])
    if int(state["step"]) != fail_at or applied != steps - 1:
        fail(f"recovered step {int(state['step'])}, applied {applied}")
    if len(recovered) != len(trained) or not all(
            bits_equal(a, b) for a, b in zip(trained, recovered)):
        fail("recovered params/opt differ from the trained state")
    log(f"{tag} recovered at step {int(state['step'])}; {applied} "
        f"differentials replayed; params+opt bitwise equal to the trained "
        f"state ({len(trained)} leaves)")
    spans = {}
    for name, _, _, _, t0_, t1_, _ in TRACER.events():
        spans[name] = spans.get(name, 0.0) + (t1_ - t0_) * 1e3
    TRACER.disable()
    log(f"{tag} snapshot_ms(d2h, all snapshots)="
        f"{spans.get('snapshot.d2h', 0.0):.1f} "
        f"persist_full_ms={spans.get('store.save_full', 0.0):.1f} "
        f"persist_batch_ms={spans.get('store.save_batch', 0.0):.1f} "
        f"flush_s={flush_s:.2f} recovery_ms={rec_ms:.1f} "
        f"(load_chain_ms={spans.get('recovery.load_chain', 0.0):.1f} "
        f"replay_ms={spans.get('recovery.replay', 0.0):.1f}) "
        f"full_bytes={store.manifest['fulls'][0]['bytes']} "
        f"copy_meter={COPY_METER.stats()}")

    # the default recovery: parallel replay of the same chain
    del state, recovered
    torch.cuda.empty_cache()
    strat.replay_device = False
    if not strat.parallel_recovery:
        fail("LowDiff's default recovery is not parallel replay")
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, applied = strat.recover()
    torch.cuda.synchronize()
    par_ms = (time.perf_counter() - t0) * 1e3
    par_peak = torch.cuda.max_memory_allocated(dev) - base
    if int(state["step"]) != fail_at or applied != steps - 1:
        fail(f"parallel recovery: step {int(state['step'])}, applied "
             f"{applied}")
    ratio = _replay_close(tree_leaves(state["params"])
                          + tree_leaves(state["opt"]), trained, applied)
    if not ratio <= 1.0:
        fail(f"parallel recovery differs from the trained state beyond "
             f"the reassociation tolerance (ratio {ratio})")
    log(f"{tag} parallel recovery (the default) of {applied} "
        f"differentials: recovery_ms={par_ms:.1f} peak device memory "
        f"above the trained copy {par_peak} B (device replay: "
        f"recovery_ms={rec_ms:.1f}, peak {rec_peak} B); within the "
        f"reassociation tolerance of the trained state (largest ratio "
        f"{ratio:.4f})")
    launches = dict(build.LAUNCHES)
    log(f"{tag} launches: {launches}")
    for k in PATH_KERNELS[compressor]:
        if launches[k] <= 0:
            fail(f"the {compressor} path did not launch {k}")
    strat.close()
    del state, trained, strat
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, diff_bytes[-1]


# ---------------------------------------------------------------- phase 4
def phase_dense(cfg, dev, steps: int = 3, tag: str = "[dense]"):
    """``steps`` dense (``--strategy none``) steps, which launch K3, then
    K3 held against its plain version on the last step's leaves.
    Returns (launch counts, step ms)."""
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
        b, prev = next(stream), state
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
    log(f"{tag} step_ms={[round(s, 3) for s in step_ms]} "
        f"losses={[round(l, 5) for l in losses]} launches={launches}")
    del state
    _k3_check(model, prev, b, tag)
    del prev
    torch.cuda.empty_cache()
    return launches, step_ms


# ---------------------------------------------------------------- phase B
def _quant_bounds(store, comp: str, key: str, rows: int):
    """Per-row error bound of a recovered leaf: the largest scale any
    quantized patch of the chain gave the row (0 for rows no patch
    quantized). Error feedback leaves |recovered - replica| <= |residual
    before| + |residual after| <= max(scale_prev, scale_now)."""
    import numpy as np
    from repro_torch.compression.quant_span import QuantSpan
    bound = np.zeros(rows, np.float32)
    for pe in store.manifest["patches"]:
        leaf = store.backend.get(pe["key"])["updates"][comp].get(key)
        if not isinstance(leaf, QuantSpan):
            continue
        for (s, e), sc in zip(leaf.extents(), leaf.scales):
            bound[s:e] = np.maximum(bound[s:e], np.asarray(sc).reshape(-1))
    return bound


def _release_pinned() -> None:
    """Hand torch's cached pinned host blocks back to the OS between
    phases (the host holds the LowDiff+ replica next)."""
    import torch
    fn = (getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                  None) or getattr(torch._C, "_host_emptyCache", None))
    if fn is not None:
        fn()


def phase_lowdiff_plus(cfg, dev, ckdir: str, steps: int = 3):
    """Phase B: LowDiff+ (incremental persists, row dirty tracking, int4
    params / int8 moments with error feedback) on full-width gpt2-l: one
    raw full and two quantized patches, then software recovery (== the
    replica, bitwise), host overlay == device overlay (K7), bitwise, and
    every recovered value within one quantization step of the replica."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.io import COPY_METER
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.compression.quant_span import QUANT_METER
    from repro_torch.core import recovery as rec
    from repro_torch.core.lowdiff_plus import LowDiffPlus, _flatten
    from repro_torch.core.steps import init_state
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import build
    from repro_torch.models.registry import build_model
    shutil.rmtree(ckdir, ignore_errors=True)
    _release_pinned()
    model = build_model(cfg)
    log(f"[plus] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{model.n_params()} params; LowDiff+ incremental, row, int4 "
        f"(moments int8), persist every step, queue 2, batch 4 x seq 64")
    store = CheckpointStore(ckdir)
    strat = LowDiffPlus(model, store, lr=1e-3, persist_interval=1,
                        persist_mode="incremental", dirty_granularity="row",
                        diff_quant="int4", queue_size=2, device=dev,
                        flush_timeout=3600.0)
    state = init_state(model, 0, mode="lowdiff_plus", device=dev)
    stream = TokenStream(cfg, 64, 4, seed=0, device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    step_ms, losses = [], []
    for _ in range(steps):
        batch = next(stream)
        t0 = time.perf_counter()
        state, metrics = strat.train_step(state, batch)
        torch.cuda.current_stream(dev).synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    if not all(math.isfinite(l) for l in losses):
        fail(f"non-finite LowDiff+ loss {losses}")
    t0 = time.perf_counter()
    strat.flush()
    flush_s = time.perf_counter() - t0
    log(f"[plus] step_ms={[round(s, 3) for s in step_ms]} "
        f"losses={[round(l, 5) for l in losses]} flush_s={flush_s:.2f} "
        f"replica apply/encode on the host: "
        f"quant={QUANT_METER.stats()}")
    log(f"[plus] persists: full {store.manifest['fulls'][0]['bytes']} B; "
        f"patches " + ", ".join(
            f"{e['key']}: {e['bytes']} B stored / {e['span_bytes']} B "
            f"logical {e.get('codec')}" for e in store.manifest["patches"]))
    if len(store.manifest["patches"]) != steps - 1:
        fail(f"expected {steps - 1} patches: {store.stats()}")

    # 1. software recovery == the replica, bit for bit
    rep = strat._replica
    soft = strat.recover_software(state)
    del state
    flat = {"params": _flatten(soft["params"]),
            "mu": _flatten(soft["opt"].mu), "nu": _flatten(soft["opt"].nu)}
    for comp in ("params", "mu", "nu"):
        for k, v in getattr(rep, comp).items():
            if not bits_equal(flat[comp][k].cpu(), torch.from_numpy(v)):
                fail(f"recover_software {comp}{k} != replica")
    if int(soft["step"]) != steps or int(soft["opt"].count) != steps:
        fail(f"recover_software step {int(soft['step'])}")
    del soft, flat
    torch.cuda.empty_cache()
    log("[plus] check 1: recover_software == replica, bitwise "
        "(params, mu, nu)")

    # 2. host overlay == device overlay (K7), bitwise
    t0 = time.perf_counter()
    host, hstep = store.load_latest_state()
    host_ms = (time.perf_counter() - t0) * 1e3
    h2d0 = COPY_METER.h2d_bytes
    t0 = time.perf_counter()
    devs, dstep = rec.load_state_device(store, device=dev)
    dev_ms = (time.perf_counter() - t0) * 1e3
    h2d = COPY_METER.h2d_bytes - h2d0
    launches = dict(build.LAUNCHES)
    if hstep != dstep or hstep != steps:
        fail(f"recovered steps host {hstep} device {dstep}")
    for comp in ("params", "mu", "nu"):
        for k in host[comp]:
            a, b = np.asarray(host[comp][k]), devs[comp][k]
            if a.dtype != b.dtype or not np.array_equal(a.view(np.uint32),
                                                         b.view(np.uint32)):
                fail(f"load_state_device {comp}{k} != load_latest_state")
    del devs
    log(f"[plus] check 2: load_state_device == load_latest_state, bitwise "
        f"({sum(len(host[c]) for c in ('params', 'mu', 'nu'))} leaves); "
        f"load_latest_state_ms={host_ms:.1f} "
        f"load_state_device_ms={dev_ms:.1f} h2d_bytes={h2d}")

    # 3. within one quantization step of the replica
    worst = 0.0
    for comp in ("params", "mu", "nu"):
        for k, v in getattr(rep, comp).items():
            got = np.asarray(host[comp][k]).reshape(v.shape[0], -1)
            want = v.reshape(v.shape[0], -1)
            bound = _quant_bounds(store, comp, k, v.shape[0])[:, None]
            diff = np.abs(got - want)
            # slack for the f32 roundings of value + residual, q * scale
            # and their difference (~1e-5 of a step)
            if not np.all(diff <= bound * np.float32(1 + 2 ** -10)):
                fail(f"recovered {comp}{k} is more than one quantization "
                     f"step from the replica")
            nz = bound > 0
            if nz.any():
                worst = max(worst, float((diff / np.where(nz, bound, 1)
                                          ).max()))
    del host
    log(f"[plus] check 3: every recovered value within max(scale_prev, "
        f"scale_now) of the replica (largest ratio {worst:.4f})")

    # 4. K7 ran on the path
    log(f"[plus] launches: {launches}")
    if launches["quant_span_apply"] <= 0:
        fail("LowDiff+ recovery did not launch quant_span_apply")
    strat.close()
    del strat, rep
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase E
def _state_leaves(state):
    from repro_torch import tree_leaves
    return tree_leaves(state["params"]) + tree_leaves(state["opt"])


def _same_state(got, want) -> bool:
    """params, mu, nu and count bitwise equal, and the same step."""
    a, b = _state_leaves(got), _state_leaves(want)
    return (len(a) == len(b) and int(got["step"]) == int(want["step"])
            and all(bits_equal(x, y) for x, y in zip(a, b)))


def _naive_dc_plain_recover(store, dev):
    """NaiveDC's recovery by the plain versions on the card: each
    differential decoded by K2's plain version, the deltas merged by the
    same pairwise plain adds, added to the full. Returns (params, mu, nu
    leaves, count, step)."""
    from repro_torch import tree_leaves
    from repro_torch.compression.sparse import is_compressed
    from repro_torch.core import recovery as rec
    from repro_torch.kernels import ref
    state, diffs = rec.load_latest_chain(store)
    state = rec.to_device(state, dev)
    payloads = [rec.to_device(p, dev) for _, p in diffs]

    def apply(comp, leaves, add):
        wires = [tree_leaves(p[comp], is_leaf=is_compressed)
                 for p in payloads]
        out = []
        for j, x in enumerate(leaves):
            deltas = [ref.topk_scatter_ref(w[j].values, w[j].indices,
                                           w[j].block).reshape(-1)[
                                               :x.numel()].reshape(x.shape)
                      for w in wires]
            out.append(add(x, rec.merge_deltas_pairwise(deltas)[0]))
        return out
    opt = state["opt"]
    leaves = (apply("params", tree_leaves(state["params"]),
                    lambda p, d: (p.float() + d).to(p.dtype))
              + apply("mu", tree_leaves(opt.mu), lambda a, b: a + b)
              + apply("nu", tree_leaves(opt.nu), lambda a, b: a + b))
    return leaves, int(opt.count) + len(diffs), diffs[-1][0]


def _baseline_kernel_checks(model, prev, state, batch, store, step: int):
    """K1, K2 and K3 against their plain versions, bitwise, on phase E's
    own leaves: K1 on the 3-Psi delta of NaiveDC's last step (its picks
    also equal to the payload the path wrote), K2 on that payload, K3 on
    the last step's params, gradient and moments (``_k3_check``). These
    launches are measurement, not the path's: the counts are put back."""
    import numpy as np
    import torch
    from repro_torch import tree_leaves
    from repro_torch.compression.sparse import is_compressed, k_for
    from repro_torch.kernels import build, ref, topk
    from repro_torch.models.param import to_tensor
    counts = dict(build.LAUNCHES)
    k = k_for(0.01)
    payload = dict(store.diffs_after(step - 1))[step]
    pairs = {"params": (state["params"], prev["params"]),
             "mu": (state["opt"].mu, prev["opt"].mu),
             "nu": (state["opt"].nu, prev["opt"].nu)}
    n = zero = 0
    for comp, (new, old) in pairs.items():
        wire = tree_leaves(payload[comp], is_leaf=is_compressed)
        for a, b, sg in zip(tree_leaves(new), tree_leaves(old), wire):
            d = a.float() - b.float()
            got = topk.topk_select(d, k)
            want = ref.topk_select_ref(ref.to_blocks(d, 1024)[0], k)
            if not all(bits_equal(x, y) for x, y in zip(got, want)):
                fail(f"K1 != plain version on the NaiveDC delta {comp} "
                     f"{tuple(d.shape)}")
            vals = to_tensor(sg.values, device=d.device)
            idx = to_tensor(np.asarray(sg.indices, np.int32),
                            device=d.device)
            if not (bits_equal(got[0], vals) and bits_equal(got[1], idx)):
                fail(f"K1 on the delta {comp} {tuple(d.shape)} != the "
                     f"payload NaiveDC wrote")
            dense = topk.topk_scatter(vals, idx, d.numel())
            plain = ref.topk_scatter_ref(vals, idx, 1024).reshape(-1)[
                :d.numel()]
            if not bits_equal(dense, plain):
                fail(f"K2 != plain version on the NaiveDC payload {comp} "
                     f"{tuple(d.shape)}")
            n += 1
            zero += int((got[0] == 0).all(dim=1).sum())
            del d, got, want, dense, plain
    build.LAUNCHES.update(counts)
    log(f"[base] K1, K2 on the 3-Psi delta of step {step} ({n} leaves, "
        f"{zero} all-zero blocks): bitwise equal to their plain versions; "
        f"K1's picks equal the payload on disk")
    _k3_check(model, prev, batch, "[base]")


def _k3_check(model, prev, batch, tag: str):
    """K3 against its plain version, bitwise, on the leaves of a dense
    step: the params and moments before it and the gradient of its batch
    (recomputed). Measurement, not the path's: the counts are put back."""
    import torch
    from repro_torch import tree_leaves
    from repro_torch.core.steps import _grads
    from repro_torch.kernels import build, fused_adam, ops, ref
    counts = dict(build.LAUNCHES)
    _, _, grads = _grads(model, prev["params"], batch, model.cfg.grad_accum)
    opt = prev["opt"]
    hyper = ops.adam_hyper_traced(1e-3, 0.9, 0.999, 1e-8, opt.count + 1)
    n = 0
    for p, g, m, v in zip(tree_leaves(prev["params"]), tree_leaves(grads),
                          tree_leaves(opt.mu), tree_leaves(opt.nu)):
        got = fused_adam.adam_tile_update(p, g, m, v, hyper)
        want = ref.adam_tile_update_ref(p, g, m, v, hyper)
        if not all(bits_equal(x, y) for x, y in zip(got, want)):
            fail(f"K3 != plain version on the leaf {tuple(p.shape)}")
        n += 1
        del got, want
    build.LAUNCHES.update(counts)
    log(f"{tag} K3 on the last step's {n} leaves ({model.cfg.param_dtype} "
        f"params): bitwise equal to its plain version")
    del grads
    torch.cuda.empty_cache()


def _lowdiff_kernel_checks(prev, payload, state, tag: str):
    """K4 and K2 against their plain versions, bitwise, on the leaves of
    a lowdiff top-k step: K4 on the params and moments before it and its
    payload (the plain version's result also equal to the state the step
    trained), K2 on that payload. Measurement, not the path's: the counts
    are put back."""
    import torch
    from repro_torch import tree_leaves
    from repro_torch.compression.sparse import is_compressed
    from repro_torch.kernels import build, ops, ref, replay, topk
    counts = dict(build.LAUNCHES)
    opt, new = prev["opt"], state["opt"]
    hyper = ops.adam_hyper_traced(1e-3, 0.9, 0.999, 1e-8, opt.count + 1)
    n = 0
    for sg, p, m, v, p2, m2, v2 in zip(
            tree_leaves(payload, is_leaf=is_compressed),
            tree_leaves(prev["params"]), tree_leaves(opt.mu),
            tree_leaves(opt.nu), tree_leaves(state["params"]),
            tree_leaves(new.mu), tree_leaves(new.nu)):
        got = replay.topk_apply(sg.values, sg.indices, p, m, v, hyper)
        want = tuple(ref.unblock(t, p.shape) for t in ref.topk_apply_ref(
            sg.values, sg.indices, *(ref.to_blocks(t, 1024)[0]
                                     for t in (p, m, v)), hyper, block=1024))
        if not all(bits_equal(x, y) for x, y in zip(got, want)):
            fail(f"{tag} K4 != plain version on the leaf {tuple(p.shape)} "
                 f"({p.dtype})")
        if not all(bits_equal(x, y) for x, y in zip(want, (p2, m2, v2))):
            fail(f"{tag} K4's plain version != the trained state on the "
                 f"leaf {tuple(p.shape)}")
        dense = topk.topk_scatter(sg.values, sg.indices, p.numel())
        plain = ref.topk_scatter_ref(sg.values, sg.indices, 1024).reshape(
            -1)[:p.numel()]
        if not bits_equal(dense, plain):
            fail(f"{tag} K2 != plain version on the payload of the leaf "
                 f"{tuple(p.shape)}")
        n += 1
        del got, want, dense, plain
    build.LAUNCHES.update(counts)
    log(f"{tag} K4 ({tree_leaves(prev['params'])[0].dtype} params) and K2 "
        f"on the last step's {n} leaves and payload: bitwise equal to their "
        f"plain versions, and the plain K4 equal to the trained state")
    torch.cuda.empty_cache()


#: phase E: strategy -> (knobs, steps, the step whose state recovers)
BASELINES = (("full_sync", {"interval": 2}, 3, 2),
             ("checkfreq", {"interval": 2}, 3, 2),
             ("gemini", {"interval": 1, "persist_interval": 100}, 3, 3),
             ("naive_dc", {"rho": 0.01, "full_interval": 3}, 5, 5))


def phase_baselines(cfg, dev, ckdir: str, lowdiff_diff_bytes: int,
                    dense_ms: float):
    """Phase E: the paper's baselines (FullSync, CheckFreq, Gemini,
    NaiveDC) on full-width, full-depth gpt2-l, batch 4 x seq 64, each in
    its own checkpoint directory, deleted after its checks. FullSync and
    CheckFreq (interval 2, steps 1-3) recover the step-2 state, Gemini
    (every step into host memory) the step-3 state, bitwise; NaiveDC
    (rho 0.01, a full at step 3, differentials 4 and 5) recovers the
    state the plain versions' decode and merge give, bitwise, and its
    lossy gap to the trained state is printed. Then one simulator line
    from the measured constants. Returns the launch counts of the four
    paths, summed."""
    import torch
    from repro_torch import tree_leaves
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.core import baselines
    from repro_torch.core.simulator import paper_profiles, simulate
    from repro_torch.core.steps import init_state
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import build
    from repro_torch.models.registry import build_model
    from repro_torch.obs.trace import TRACER
    classes = {"full_sync": baselines.FullSync,
               "checkfreq": baselines.CheckFreq,
               "gemini": baselines.Gemini, "naive_dc": baselines.NaiveDC}
    model = build_model(cfg)
    state_bytes = 12 * model.n_params()
    log(f"[base] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{model.n_params()} params, dense state (params, mu, nu f32) "
        f"{state_bytes} B; dense steps, batch 4 x seq 64")
    total = {k: 0 for k in build.LAUNCHES}
    measured = {}
    for name, kw, steps, want_step in BASELINES:
        root = os.path.join(ckdir, name)
        shutil.rmtree(root, ignore_errors=True)
        _release_pinned()
        store = CheckpointStore(root)
        strat = classes[name](model, store, lr=1e-3, device=dev, **kw)
        state = init_state(model, 0, mode="dense", device=dev)
        stream = TokenStream(cfg, 64, 4, seed=0, device=dev)
        TRACER.clear()
        TRACER.enable()
        torch.cuda.synchronize()
        build.reset_launches()
        step_ms, losses, kept, prev, batch = [], [], None, None, None
        for _ in range(steps):
            prev, batch = state, next(stream)
            t0 = time.perf_counter()
            state, metrics = strat.train_step(state, batch)
            torch.cuda.current_stream(dev).synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            if int(state["step"]) == want_step:
                kept = state        # replaced, never written, by later steps
        if not all(math.isfinite(l) for l in losses):
            fail(f"{name}: non-finite loss {losses}")
        t0 = time.perf_counter()
        strat.flush()
        flush_s = time.perf_counter() - t0
        if name != "naive_dc":
            del prev
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got, applied = strat.recover()
        torch.cuda.synchronize()
        rec_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(build.LAUNCHES)
        spans = {}
        for sname, _, _, _, t0_, t1_, _ in TRACER.events():
            spans.setdefault(sname, []).append((t1_ - t0_) * 1e3)
        TRACER.disable()
        stall = spans.get("ckpt.compress", [])
        if name == "naive_dc":
            leaves, count, step = _naive_dc_plain_recover(store, dev)
            mine = _state_leaves(got)
            if not (applied == 2 and int(got["step"]) == step == want_step
                    and int(got["opt"].count) == count
                    and all(bits_equal(a, b) for a, b in
                            zip(mine[:-1], leaves))):
                fail("naive_dc: recovered state != the plain versions' "
                     "decode and merge of the same chain")
            gaps = {}
            for comp, a, b in (
                    ("params", got["params"], state["params"]),
                    ("mu", got["opt"].mu, state["opt"].mu),
                    ("nu", got["opt"].nu, state["opt"].nu)):
                gaps[comp] = max(abs_err(x, y) for x, y in
                                 zip(tree_leaves(a), tree_leaves(b)))
            log(f"[base] naive_dc: recovered at step {int(got['step'])} "
                f"from the full at 3 + {applied} differentials, bitwise "
                f"equal to the plain versions' K2 decode and pairwise "
                f"merge; lossy gap to the trained state (not gated): "
                f"max |recovered - trained| params {gaps['params']:.6g} "
                f"mu {gaps['mu']:.6g} nu {gaps['nu']:.6g}")
            del leaves
            _baseline_kernel_checks(model, prev, state, batch, store, steps)
            del prev
            for k in ("topk_select", "topk_scatter"):
                if launches[k] <= 0:
                    fail(f"naive_dc did not launch {k}")
        else:
            if kept is None or not _same_state(got, kept):
                fail(f"{name}: recovered state != the trained state at "
                     f"step {want_step}")
            log(f"[base] {name}: recovered at step {int(got['step'])}, "
                f"bitwise equal to the trained state of that step")
        if launches["adam_tile_update"] <= 0:
            fail(f"{name} did not launch adam_tile_update")
        for k, v in launches.items():
            total[k] += v
        d2h = spans.get("snapshot.d2h", [])
        saves = spans.get("store.save_full", [])
        log(f"[base] {name}: step_ms first={step_ms[0]:.3f} "
            f"median_rest={statistics.median(step_ms[1:]):.3f} "
            f"all={[round(t, 3) for t in step_ms]} "
            f"ckpt_time_s={strat.ckpt_time:.3f} flush_s={flush_s:.3f} "
            f"bytes_written={store.bytes_written} "
            f"recovery_ms={rec_ms:.1f} "
            f"save_full_ms={[round(t, 1) for t in saves]} "
            f"snapshot_d2h_ms={[round(t, 1) for t in d2h]} "
            + (f"compress_stall_ms={[round(t, 3) for t in stall]} "
               if stall else "")
            + f"losses={[round(l, 5) for l in losses]} launches="
            f"{ {k: v for k, v in launches.items() if v} }")
        measured[name] = {"spans": spans, "stall": stall,
                          "full_bytes": (store.manifest["fulls"][0]["bytes"]
                                         if store.manifest["fulls"] else 0)}
        strat.close()
        del state, got, kept, strat, batch
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    _release_pinned()

    # the failure simulator, fed this run's constants
    full_bytes = measured["full_sync"]["full_bytes"]
    write_s = measured["full_sync"]["spans"]["store.save_full"][0] / 1e3
    d2h_s = measured["gemini"]["spans"]["snapshot.d2h"][-1] / 1e3
    stall_s = statistics.median(measured["naive_dc"]["stall"]) / 1e3
    consts = dict(iter_time=dense_ms / 1e3, full_bytes=full_bytes,
                  diff_bytes=lowdiff_diff_bytes, write_bw=full_bytes / write_s,
                  d2h_bw=state_bytes / d2h_s, compress_stall=stall_s / 3)
    ratios = {}
    for pname, prof in paper_profiles(**consts).items():
        ratios[pname] = [
            round(statistics.mean(simulate(prof, run_iters=20000,
                                           mtbf_s=3600 * h, seed=sd)
                                  .effective_ratio for sd in range(3)), 6)
            for h in (0.5, 1, 2)]
    log(f"[sim] paper_profiles from this run: iter_time="
        f"{consts['iter_time']:.4f} s (phase 4 dense step), "
        f"full_bytes={full_bytes} (full_sync), "
        f"write_bw={consts['write_bw']:.4g} B/s (its save_full), "
        f"d2h_bw={consts['d2h_bw']:.4g} B/s (gemini's last copy), "
        f"compress_stall={consts['compress_stall']:.4g} s per Psi "
        f"(naive_dc's 3-Psi stall / 3), diff_bytes={lowdiff_diff_bytes} "
        f"(phase 3's top-k payload); effective_ratio at MTBF 0.5/1/2 h "
        f"(20000 iterations, mean of seeds 0-2): {ratios}")
    return total


# ---------------------------------------------------------------- phase F
def phase_accum(dev, ckdir: str):
    """Phase F: gradient accumulation and the other dense configs at full
    width. granite-3-8b (d 4096, 32 H / 8 KV, d_ff 12800, vocab 49155,
    bf16 params, grad_accum 2) cut in depth to 4 of its 40 layers (all
    40 need ~8.4 B parameters, over 110 GB with f32 moments and the f32
    EF residual) goes through ``phase_main`` as phases C and D do, with
    K4 and K2 held against their plain versions on its last step as in
    phase 3; stablelm-1.6b at full width and depth takes three dense
    steps through ``phase_dense``, K3 held as in phase 4.
    Returns (granite's launch counts, stablelm's)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import DTYPES
    from repro_torch.models.registry import build_model
    g = get_config("granite-3-8b")
    g = g.replace(n_layers=4)
    n = build_model(g).n_params()
    pbytes = DTYPES[g.param_dtype].itemsize
    log(f"[granite] {g.name} cut in depth to {g.n_layers} of 40 layers: "
        f"d={g.d_model}, {g.n_heads} H / {g.n_kv_heads} KV, d_ff {g.d_ff}, "
        f"vocab {g.vocab}, {g.param_dtype} params, grad_accum "
        f"{g.grad_accum} ({g.grad_accum_dtype}); {n} params, lowdiff "
        f"state (params, f32 mu, nu, EF) {n * (pbytes + 12)} B")
    lg, _ = phase_main(g, dev, ckdir, "topk", steps=4, start=3,
                       full_interval=4, tag="[granite]")
    s = get_config("stablelm-1.6b")
    n = build_model(s).n_params()
    log(f"[stablelm] {s.name} at full width and depth: {s.n_layers} "
        f"layers, d={s.d_model}, {s.n_heads} H / {s.n_kv_heads} KV, d_ff "
        f"{s.d_ff}, vocab {s.vocab}, {s.param_dtype} params; {n} params, "
        f"dense state {n * 12} B; 3 dense steps, batch 4 x seq 64")
    ls, _ = phase_dense(s, dev, tag="[stablelm]")
    return lg, ls


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
    ("span_pack", "src/repro_torch/kernels/csrc/span.cu",
     "src/repro/kernels/pack.py:105"),
    ("quant_span_decode", "src/repro_torch/kernels/csrc/span.cu",
     "src/repro/kernels/replay.py:185"),
    ("quant_span_apply", "src/repro_torch/kernels/csrc/span.cu",
     "src/repro/kernels/replay.py:205"),
    ("pack_select", "src/repro_torch/kernels/csrc/topk.cu",
     "src/repro/kernels/pack.py:31"),
    ("pack_scatter", "src/repro_torch/kernels/csrc/topk.cu",
     "src/repro/kernels/pack.py:130"),
    ("packed_apply", "src/repro_torch/kernels/csrc/replay.cu",
     "src/repro/kernels/replay.py:76"),
    ("quantize", "src/repro_torch/kernels/csrc/quant8.cu",
     "src/repro/kernels/quant8.py:16"),
    ("dequantize", "src/repro_torch/kernels/csrc/quant8.cu",
     "src/repro/kernels/quant8.py:42"),
    ("quant_apply", "src/repro_torch/kernels/csrc/replay.cu",
     "src/repro/kernels/replay.py:85"),
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
    from repro_torch.kernels import build
    cfg = get_config("gpt2-l")

    phase_build()
    res = phase_parity(cfg, dev)
    res.update(phase_compressors(cfg, dev))
    log(f"[time] build + phase 2: {time.perf_counter() - t_all:.1f} s")
    build.reset_launches()
    res.update(phase_span(cfg, dev))
    log(f"[time] + phase A: {time.perf_counter() - t_all:.1f} s")
    # no training or recovery path packs or decodes alone on the card
    # (the replica quantizes on the host, and K7 decodes inside itself,
    # as in the reference): K5/K6 launches are those of phase A's checks
    launches = {k: 0 for k in res}
    launches.update({k: res[k]["parity_launches"]
                     for k in ("span_pack", "quant_span_decode")})
    if args.only == "all":
        got, diff_bytes = phase_main(cfg, dev, args.ckpt_dir)
        launches.update({k: v for k, v in got.items()
                         if k in PATH_KERNELS["topk"]})
        got, dense_ms = phase_dense(cfg, dev)
        launches["adam_tile_update"] = got["adam_tile_update"]
        log(f"[time] + phases 3, 4: {time.perf_counter() - t_all:.1f} s")
        launches["quant_span_apply"] = phase_lowdiff_plus(
            cfg, dev, args.ckpt_dir)["quant_span_apply"]
        log(f"[time] + phase B: {time.perf_counter() - t_all:.1f} s")
        _release_pinned()
        for phase, comp in (("C", "packed"), ("D", "quant8")):
            got, _ = phase_main(cfg, dev, args.ckpt_dir, comp, steps=4,
                                start=3, full_interval=4)
            launches.update({k: v for k, v in got.items()
                             if k in PATH_KERNELS[comp]})
            log(f"[time] + phase {phase}: {time.perf_counter() - t_all:.1f} s")
        # K1-K4 also run on the paths of phases E and F: their counts add
        got = phase_baselines(cfg, dev, args.ckpt_dir, diff_bytes,
                              statistics.median(dense_ms[1:]))
        for k in ("topk_select", "topk_scatter", "adam_tile_update"):
            launches[k] += got[k]
        log(f"[time] + phase E: {time.perf_counter() - t_all:.1f} s")
        granite, stablelm = phase_accum(dev, args.ckpt_dir)
        for k in PATH_KERNELS["topk"]:
            launches[k] += granite[k]
        launches["adam_tile_update"] += stablelm["adam_tile_update"]
        log(f"[time] + phase F: {time.perf_counter() - t_all:.1f} s")
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
