"""Driver of a ``train`` traffic: one trainer in a closed loop.

Set-up builds the model, the benchmark's weights from the seed, the
training state and (``strategy: lowdiff``) LowDiff over the pure-RAM
store, and drives that same object through its first three steps, which
the reference follows: each step's loss, the gradient the optimizer got
at step 1 (read from the first moment, ``mu_1 = (1 - b1) g``), and the
parameters' change after step 3 as step 4 gets them. LowDiff starts its
step counter so that step 3 writes a full; set-up flushes and reads that
full and step 3's differential back from the store. Warm-up then runs
the cell's own loop through ``warm_fulls`` fulls or ``warm_steps``
steps: the first full pins the snapshot's host blocks, the later ones
reuse them, so the window pins nothing.

The window runs steps until ``seconds`` have passed and, with LowDiff, a
whole number of full intervals is done; ``step_ms`` is the window over
its steps. A traced run then profiles ``profile_steps`` more steps.
"""
from __future__ import annotations

import time

import torch

from chipbench import compare, harness, inputs, program
from chipbench.reference import follow
from chipbench.reference.decoder import DTYPES, Precision
from chipbench.reference.optim import B1

CHECKED = 3


def _diff_norms(payload):
    """{leaf: norm of the dense differential}: a top-k payload's indices
    are distinct within a block, so it is the norm of its values."""
    return {k: float(torch.linalg.vector_norm(torch.as_tensor(v).float()))
            for k, (v, _, _) in program.sparse_leaves(payload).items()}


class Trainer:
    """The training object of a cell, built from the seed and driven
    through the steps the reference follows (``prog`` holds what they
    read); ``one()`` runs one more step of the cell's loop."""

    def __init__(self, cell, device, seed: int):
        m, t = cell.model, cell.traffic
        self.device = device
        self.TL = program.timeline()
        self.lowdiff = t["strategy"] == "lowdiff"
        model = program.build_model(m)
        weights = inputs.weights(m, seed, device)
        program.check_layout(model, weights)
        self.store = self.strat = None
        if self.lowdiff:
            self.store = program.ram_store(t)
            self.strat = program.lowdiff(model, self.store, t, device)
            self.step = self.strat.train_step
        else:
            self.step = program.dense_step(model, t)
        self.state = program.init_state(model, weights, t, device)
        self.n = t["start_step"]
        self.batches = inputs.Batches(m["vocab"], t["batch"], t["seq"],
                                      seed, device)
        prog = self.prog = {"loss": []}
        for s in range(1, CHECKED + 1):
            prog["loss"].append(float(self.one()))
            if s == 1:
                prog["g1"] = compare.leaf_norms(
                    program.flatten(self.state["opt"].mu), 1.0 / (1.0 - B1))
        prog["dp3"] = {k: follow.norm(v.float() - weights[k].float())
                       for k, v in program.flatten(
                           self.state["params"]).items()}
        if self.lowdiff:
            prog.update(_read_back(self.strat, self.store, weights, t,
                                   device))

    def one(self):
        self.n += 1
        self.TL.begin(self.n)
        t0 = time.perf_counter()
        self.state, met = self.step(self.state, next(self.batches))
        self.TL.commit(self.n, time.perf_counter() - t0)
        return met["loss"]

    def close(self):
        if self.strat is not None:
            self.strat.close()
        self.state = self.strat = self.store = self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(cell, device, seed: int, seconds: float, trace: bool):
    m, t = cell.model, cell.traffic
    t_proc = harness.process_start()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    TL, TR = program.timeline(), program.tracer()
    TL.clear()
    TR.clear()
    tr = Trainer(cell, device, seed)
    # ---- warm-up through the cell's own loop
    if tr.lowdiff:
        while tr.strat.full_saves < t["warm_fulls"]:
            tr.one()
    else:
        for _ in range(t["warm_steps"]):
            tr.one()

    # ---- the window
    if trace:
        TR.enable()
    f = t["full_interval"] if tr.lowdiff else 1
    first = tr.n + 1
    losses = []
    harness.sync(device)
    w0 = time.perf_counter()
    setup_s = w0 - t_proc
    while True:
        losses.append(tr.one())
        if (time.perf_counter() - w0 >= seconds
                and (tr.n - first + 1) % f == 0):
            break
    harness.sync(device)
    w1 = time.perf_counter()
    n = tr.n - first + 1
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    spans = [(e[0], e[4], e[5], e[6] or {}) for e in TR.events()
             if w0 <= e[5] <= w1]
    records = [r for r in TL.records() if r.get("step", -1) >= first]
    profile = None
    if trace and device.type == "cuda":
        profile = harness.profiled(
            lambda: [tr.one() for _ in range(t["profile_steps"])], device)
    TR.disable()
    extra = {"window_steps": n,
             "window_fulls": sum(1 for s in spans if s[0] == "persist.full")}
    prog = tr.prog
    tr.close()

    # ---- the reference, once the window has closed
    ref = reference(cell, device, seed)
    numbers = numbers_of(prog, ref, tr.lowdiff)
    extra["loss"] = prog["loss"]
    extra["ref_loss"] = ref["loss"]
    return harness.Run(
        kind="train", e2e={"step_ms": (w1 - w0) / n * 1e3,
                           "setup_s": setup_s},
        attempted=n, failed=failed, memory_peak_bytes=peak,
        numbers=numbers, model=m, traffic=t, units=n,
        spans=spans, timeline=records, profile=profile, extra=extra)


def reference(cell, device, seed: int, fp8: bool = False, half=False):
    """The reference's readings of the checked steps; ``fp8`` computes
    it in float8 (the control), ``half`` leaves half the batch out (a
    fault), both put in the program's place."""
    prec = Precision(DTYPES[cell.model["compute_dtype"]], fp8=fp8)
    return follow.follow(cell.model, cell.traffic, seed, device, CHECKED,
                         prec=prec, record=(CHECKED,), half=half)


def as_program(ref: dict) -> dict:
    """The readings of a reference run, put in the program's place."""
    return {"loss": ref["loss"], "g1": ref["g"][1],
            "dp3": ref["dp"][CHECKED], "full_dp": ref["dp"][CHECKED],
            "full_mu": ref["mu"][CHECKED], "full_nu": ref["nu"][CHECKED],
            "diff3": ref["g"][CHECKED]}


def _read_back(strat, store, weights, t, device) -> dict:
    """Step 3's full and differential, read back from the store."""
    strat.flush()
    want = t["start_step"] + CHECKED
    entry = store.latest_full()
    out = {"full_step": entry["step"] if entry else None}
    if entry is None or entry["step"] != want:
        return out
    full = store.load_full(entry)
    host = {"p": program.flatten(full["params"]),
            "mu": program.flatten(full["opt"].mu),
            "nu": program.flatten(full["opt"].nu)}
    del full
    to_tensor = program.to_tensor
    out["full_dp"] = {k: follow.norm(to_tensor(v, device).float()
                                     - weights[k].float())
                      for k, v in host["p"].items()}
    for part in ("mu", "nu"):
        out["full_" + part] = {
            k: follow.norm(to_tensor(v, device))
            for k, v in host[part].items()}
    del host
    diffs = dict(store.diffs_after(want - 1))
    if want in diffs:
        out["diff3"] = _diff_norms(diffs[want])
    return out


def numbers_of(prog: dict, ref: dict, lowdiff: bool) -> dict:
    still = compare.still_leaves(ref["graw1"])
    out = {"loss_gap": compare.loss_gap(prog["loss"], ref["loss"]),
           "grad1_gap": compare.norm_gap(prog["g1"], ref["g"][1]),
           "dparam3_gap": compare.norm_gap(prog["dp3"], ref["dp"][CHECKED],
                                           skip=still)}
    if lowdiff:
        inf = float("inf")
        out["full3_gap"] = max(
            compare.norm_gap(prog["full_dp"], ref["dp"][CHECKED], skip=still),
            compare.norm_gap(prog["full_mu"], ref["mu"][CHECKED]),
            compare.norm_gap(prog["full_nu"], ref["nu"][CHECKED])) \
            if "full_dp" in prog else inf
        out["diff3_gap"] = (compare.norm_gap(prog["diff3"], ref["g"][CHECKED])
                            if "diff3" in prog else inf)
    return out
