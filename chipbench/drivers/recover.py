"""Driver of a ``recover`` traffic: recovery of one chain, again and
again.

Set-up trains ``chain_steps`` LowDiff steps from step ``start_step`` into
the pure-RAM store, so the first step writes a full and the others the
differentials after it; as each step hands its differential on, the
benchmark keeps a host copy of it, and of the state the full holds. Then
it flushes and drops the training state (the failure), and recovers once
to warm up. The window calls ``recover()`` until ``seconds`` have passed,
each recovered state dropped before the next call but the last;
``recovery_ms`` is the window over its recoveries. A traced run then
profiles ``profile_recoveries`` more.

The reference cannot make the chain without the program's 20 steps, so
it follows the program from its own state: it replays the kept
differentials onto the kept start with plain Adam, and every recovery is
held against that. The start and the stage this skips are checked by
themselves: the reference's own step 1 from the seed against the state
the full holds, and its step 2 against the first differential of the
chain.
"""
from __future__ import annotations

import statistics
import time

import torch

from chipbench import compare, harness, inputs, program
from chipbench.reference import follow
from chipbench.reference.decoder import DTYPES, Precision
from chipbench.reference.optim import B1


def fingerprint(state) -> list:
    """Exact per-leaf checksums of a recovered state's params and
    moments: the sum of each leaf's bit patterns, in int64."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    leaves = (list(program.flatten(state["params"]).values())
              + list(program.flatten(state["opt"].mu).values())
              + list(program.flatten(state["opt"].nu).values()))
    return torch.stack([torch.sum(x.view(view[x.dtype]), dtype=torch.int64)
                        for x in leaves]).tolist()


class Chain:
    """LowDiff trained ``chain_steps`` steps into the RAM store, the
    training state dropped; ``kept`` holds the start and the chain, and
    ``prog`` what the start checks read."""

    def __init__(self, cell, device, seed: int):
        m, t = cell.model, cell.traffic
        self.device = device
        model = program.build_model(m)
        weights = inputs.weights(m, seed, device)
        program.check_layout(model, weights)
        self.store = program.ram_store(t)
        self.strat = program.lowdiff(model, self.store, t, device)
        kept = []                  # each step's differential, on the host
        produce = self.strat.step_fn

        def step_fn(state, batch):
            out = produce(state, batch)
            kept.append({k: (v.cpu(), i.cpu(), shape) for k, (v, i, shape)
                         in program.sparse_leaves(out[2]).items()})
            return out
        self.strat.step_fn = step_fn
        state = program.init_state(model, weights, t, device)
        batches = inputs.Batches(m["vocab"], t["batch"], t["seq"], seed,
                                 device)
        state, _ = self.strat.train_step(state, next(batches))
        self.count0 = int(state["step"]) - t["start_step"]
        flat = {"params": program.flatten(state["params"]),
                "mu": program.flatten(state["opt"].mu),
                "nu": program.flatten(state["opt"].nu)}
        self.prog = {
            "g1": compare.leaf_norms(flat["mu"], 1.0 / (1.0 - B1)),
            "dp1": {k: follow.norm(v.float() - weights[k].float())
                    for k, v in flat["params"].items()}}
        self.start = {part: {k: v.cpu() for k, v in leaves.items()}
                      for part, leaves in flat.items()}
        del flat
        for _ in range(t["chain_steps"] - 1):
            state, _ = self.strat.train_step(state, next(batches))
        self.want_step = int(state["step"])
        self.strat.step_fn = produce
        self.strat.flush()
        program.release_pinned()     # the window pins nothing
        del state, weights
        self.chain = kept[1:]
        self.prog["diff2"] = {k: follow.norm(v)
                              for k, (v, _, _) in self.chain[0].items()}
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def recover(self):
        """(recovered state, whether it stands at the chain's end)."""
        got, applied = self.strat.recover()
        return got, (int(got["step"]) == self.want_step
                     and applied == len(self.chain))

    def close(self):
        self.strat.close()
        self.strat = self.store = None


def run(cell, device, seed: int, seconds: float, trace: bool):
    m, t = cell.model, cell.traffic
    t_proc = harness.process_start()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    TL, TR = program.timeline(), program.tracer()
    TL.clear()
    TR.clear()
    ch = Chain(cell, device, seed)
    got, _ = ch.recover()           # warm-up
    del got
    if trace:
        TR.enable()
    fps, bad, each = [], 0, []
    last = None
    harness.sync(device)
    w0 = time.perf_counter()
    setup_s = w0 - t_proc
    while True:
        last = None
        last, ok = ch.recover()
        fps.append(fingerprint(last))
        bad += not ok
        each.append(time.perf_counter() - w0 - sum(each))
        if time.perf_counter() - w0 >= seconds:
            break
    harness.sync(device)
    w1 = time.perf_counter()
    n = len(fps)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    spans = [(e[0], e[4], e[5], e[6] or {}) for e in TR.events()
             if w0 <= e[5] <= w1]
    profile = None
    if trace and device.type == "cuda":
        profile = harness.profiled(
            lambda: [ch.recover() for _ in range(t["profile_recoveries"])],
            device)
    TR.disable()
    ch.close()
    links = len(ch.chain)

    # ---- the reference, once the window has closed
    numbers = judge(cell, device, seed, ch, last, fps)
    return harness.Run(
        kind="recover", e2e={"recovery_ms": (w1 - w0) / n * 1e3,
                             "setup_s": setup_s},
        attempted=n, failed=bad, memory_peak_bytes=peak, numbers=numbers,
        model=m, traffic=t, units=n, spans=spans,
        profile=profile,
        extra={"recoveries": n, "chain": links,
               "each_s": [round(x, 3) for x in each],
               "recovered_step": ch.want_step})


def program_leaves(state):
    flat = {"p": program.flatten(state["params"]),
            "mu": program.flatten(state["opt"].mu),
            "nu": program.flatten(state["opt"].nu)}
    return lambda name: tuple(flat[part][name] for part in ("p", "mu", "nu"))


def judge(cell, device, seed: int, ch: Chain, last, fps,
          fp8: bool = False) -> dict:
    """The recover cell's numbers. ``last`` is the last recovery's state
    (None: the reference's replay in bfloat16 takes its place, the
    control), held against the reference; ``fps`` every recovery's
    fingerprint, each of which has to equal the last's bit for bit."""
    t = cell.traffic
    got = (program_leaves(last) if last is not None else
           lambda name: follow.replay(ch.start, ch.chain, ch.count0, t,
                                      device, name, torch.bfloat16))
    numbers = {}
    numbers["replay_gap"] = replay_gap(got, ch, t, device)
    if last is not None:
        mine = fingerprint(last)
        numbers["recoveries_unequal"] = float(sum(fp != mine for fp in fps))
    del got, last
    ch.start = ch.chain = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prec = Precision(DTYPES[cell.model["compute_dtype"]])
    ref = follow.follow(cell.model, t, seed, device, 2, prec=prec,
                        record=(1,))
    prog = ch.prog
    if fp8:
        ctl = follow.follow(cell.model, t, seed, device, 2,
                            prec=Precision(prec.dtype, fp8=True),
                            record=(1,))
        prog = {"g1": ctl["g"][1], "dp1": ctl["dp"][1], "diff2": ctl["g"][2]}
    still = compare.still_leaves(ref["graw1"])
    numbers["grad1_gap"] = compare.norm_gap(prog["g1"], ref["g"][1])
    numbers["dparam1_gap"] = compare.norm_gap(prog["dp1"], ref["dp"][1],
                                              skip=still)
    numbers["diff2_gap"] = compare.norm_gap(prog["diff2"], ref["g"][2])
    return numbers


def replay_gap(got, ch: Chain, t: dict, device) -> float:
    """The worst leaf of |x_got - x_ref| over the reference's change of
    x during the replay, or the median leaf's, for x in params, mu and
    nu. ``got(name)`` gives a leaf's (p, mu, nu) as recovered."""
    parts = ("p", "mu", "nu")
    base = {"p": "params", "mu": "mu", "nu": "nu"}
    diff = {part: {} for part in parts}
    moved = {part: {} for part in parts}
    for name in ch.start["params"]:
        refs = follow.replay(ch.start, ch.chain, ch.count0, t, device, name)
        for part, mine, x in zip(parts, got(name), refs):
            s0 = ch.start[base[part]][name].to(device).float()
            diff[part][name] = follow.norm(mine.float() - x.float())
            moved[part][name] = follow.norm(x.float() - s0)
    worst = 0.0
    for part in parts:
        med = statistics.median(moved[part].values())
        worst = max(worst, max(diff[part][k] / max(moved[part][k], med,
                                                   1e-30)
                               for k in diff[part]))
    return worst
