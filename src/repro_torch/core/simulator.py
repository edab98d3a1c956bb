"""Event-driven failure/checkpoint simulator (Exp. 3, 4, 9, 10), a copy
of ``repro.core.simulator`` (numpy only).

The paper's cluster-scale results (wasted time under MTBF, effective
training-time ratio vs #GPUs) depend on wall-clock constants of a
cluster that one card cannot reproduce directly; the simulator replays
the *logic* of each strategy with measured-or-paper-sourced constants
(``chip_smoke.py`` phase E feeds it the card's):

  iter_time          seconds per training iteration
  ckpt_overhead      extra seconds added to an iteration that checkpoints
  ckpt_interval      iterations between (differential or full) checkpoints
  recovery(t_fail)   seconds to restore + iterations of lost progress

Failures arrive as a Poisson process with the given MTBF. Deterministic
given the seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class StrategyProfile:
    name: str
    iter_time: float                 # s, no checkpointing
    ckpt_overhead: float             # s added on checkpointing iterations
    ckpt_interval: int               # iterations between checkpoints
    restore_time: float              # s to load/restore a checkpoint
    per_diff_replay: float = 0.0     # s per differential replayed
    full_interval: Optional[int] = None   # for differential strategies
    batch_size: int = 1              # differentials lost with a failure


@dataclasses.dataclass
class SimResult:
    total_time: float
    useful_time: float
    wasted_time: float
    failures: int

    @property
    def effective_ratio(self) -> float:
        return self.useful_time / self.total_time


def simulate(profile: StrategyProfile, *, run_iters: int, mtbf_s: float,
             seed: int = 0) -> SimResult:
    rng = np.random.default_rng(seed)
    t = 0.0
    useful = 0.0
    done = 0
    failures = 0
    next_failure = rng.exponential(mtbf_s)
    last_ckpt_iter = 0

    while done < run_iters:
        it = profile.iter_time
        if (done + 1) % profile.ckpt_interval == 0:
            it += profile.ckpt_overhead
        if t + it >= next_failure:
            # failure mid-iteration: lose progress back to last checkpoint
            failures += 1
            t = next_failure
            lost_iters = done - last_ckpt_iter
            # half a batch of differentials lost on average (paper §V-C)
            lost_iters += profile.batch_size / 2.0
            done = max(last_ckpt_iter, 0)
            useful -= lost_iters * profile.iter_time
            # restore + replay differentials since the last full checkpoint
            n_diffs = 0
            if profile.full_interval:
                n_diffs = (last_ckpt_iter % profile.full_interval)
            t += profile.restore_time + n_diffs * profile.per_diff_replay
            next_failure = t + rng.exponential(mtbf_s)
            continue
        t += it
        done += 1
        useful += profile.iter_time
        if done % profile.ckpt_interval == 0:
            last_ckpt_iter = done

    useful = max(useful, 0.0)
    return SimResult(total_time=t, useful_time=useful,
                     wasted_time=t - useful, failures=failures)


# ----------------------------------------------------------------------
# Strategy profile factories: constants measured on the card or taken
# from the paper's hardware description, scaled by model
# checkpoint size.
# ----------------------------------------------------------------------

def paper_profiles(*, iter_time: float, full_bytes: float,
                   diff_bytes: float, write_bw: float = 5e9,
                   d2h_bw: float = 20e9, compress_stall: float = 0.0,
                   batch_size: int = 2, full_interval: int = 20):
    """Profiles for the five strategies with a shared cost model."""
    full_write = full_bytes / write_bw
    full_snap = full_bytes / d2h_bw
    diff_write = diff_bytes / write_bw

    return {
        # blocking snapshot + blocking write every 5 iterations
        "full_sync": StrategyProfile(
            "full_sync", iter_time, full_snap + full_write, 5,
            restore_time=full_write * 2),
        # synchronous snapshot every 10 iterations, async persist
        "checkfreq": StrategyProfile(
            "checkfreq", iter_time, full_snap, 10,
            restore_time=full_write * 2),
        # per-iteration in-memory ckpt; traffic scheduling hides most of
        # the peer copy — ~15% of the snapshot is non-overlappable
        "gemini": StrategyProfile(
            "gemini", iter_time, full_snap * 0.15, 1,
            restore_time=full_snap),
        # per-checkpoint: compress the 3Ψ differential (blocking) + write;
        # run at its own feasible interval (Exp. 4: 2-8 iterations)
        "naive_dc": StrategyProfile(
            "naive_dc", iter_time,
            compress_stall * 3 + diff_bytes * 3 / write_bw, 4,
            restore_time=full_write * 2,
            per_diff_replay=diff_bytes * 3 / d2h_bw,
            full_interval=full_interval),
        # per-iteration; the compressed-gradient write overlaps with the
        # iteration (Fig. 4) — only the overflow beyond one iteration stalls
        "lowdiff": StrategyProfile(
            "lowdiff", iter_time,
            max(0.0, diff_write - iter_time), 1,
            restore_time=full_write * 2, per_diff_replay=diff_bytes / d2h_bw,
            full_interval=full_interval, batch_size=batch_size),
        # layer-wise snapshot overlap leaves ~8% of the D2H exposed;
        # recovery from host memory
        "lowdiff_plus_s": StrategyProfile(
            "lowdiff_plus_s", iter_time, full_snap * 0.08, 1,
            restore_time=full_snap * 0.5),
        "lowdiff_plus_p": StrategyProfile(
            "lowdiff_plus_p", iter_time, full_snap * 0.08,
            max(1, int(np.ceil(full_write / iter_time))),
            restore_time=full_write * 2),
    }
