"""Checkpoint configuration optimization (paper §V-C, Eq. 8-10).

Models the wasted time as a function of full-checkpoint frequency f
(full checkpoints per iteration, i.e. 1/FCF-interval) and differential
batching size b, and returns the closed-form optimum (f*, b*). A grid
verifier cross-checks the closed form (used by tests and Table-I-style
benchmarks), and ``OnlineTuner`` adapts the constants from runtime
measurements the way §VII's optimal-configuration module does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SystemParams:
    """Constants of Eq. 8 (units: iterations for time-like quantities)."""
    N: int = 8            # GPUs/chips
    M: float = 3600.0     # mean time between failures
    W: float = 5e9        # checkpoint write bandwidth (bytes/iteration-time)
    S: float = 1e9        # full checkpoint size (bytes)
    T: float = 1e5        # total training run-time
    R_F: float = 10.0     # time to load a full checkpoint
    R_D: float = 0.5      # time to merge one differential checkpoint


def wasted_time(f: float, b: float, p: SystemParams) -> float:
    """Eq. (8). f in (0, 1]: full checkpoints per iteration; b >= 1."""
    recovery = (p.N * p.T / p.M) * (
        b / 2.0 + p.R_F + (p.R_D / 2.0) * (1.0 / (f * b) - 1.0))
    steady = p.N * p.T * p.S * f / p.W
    return recovery + steady


def optimal_config(p: SystemParams) -> Tuple[float, float]:
    """Eq. (10): (f*, b*) closed form."""
    f_star = (p.R_D * p.W ** 2 / (4.0 * p.S ** 2 * p.M ** 2)) ** (1.0 / 3.0)
    b_star = (2.0 * p.S * p.R_D * p.M / p.W) ** (1.0 / 3.0)
    return f_star, b_star


def grid_verify(p: SystemParams, f_grid=None, b_grid=None):
    """Brute-force minimum over a grid (tests the closed form)."""
    f_star, b_star = optimal_config(p)
    if f_grid is None:
        f_grid = np.geomspace(f_star / 30, min(1.0, f_star * 30), 400)
    if b_grid is None:
        b_grid = np.geomspace(max(1e-2, b_star / 30), b_star * 30, 400)
    F, B = np.meshgrid(f_grid, b_grid, indexing="ij")
    Wt = np.vectorize(lambda f, b: wasted_time(f, b, p))(F, B)
    i, j = np.unravel_index(np.argmin(Wt), Wt.shape)
    return float(F[i, j]), float(B[i, j]), float(Wt[i, j])


def practical_config(p: SystemParams, max_interval: int = 1000):
    """Integer (full-checkpoint interval, batch size) actually deployed."""
    f_star, b_star = optimal_config(p)
    interval = int(np.clip(round(1.0 / max(f_star, 1e-9)), 1, max_interval))
    b = int(np.clip(round(b_star), 1, interval))
    return interval, b


class OnlineTuner:
    """Stepwise runtime adaptation of (M, W, R_D) -> (interval, batch).

    Mirrors the paper's optimal-configuration module: start from defaults,
    fold in observed failure gaps / write bandwidths / merge times with an
    EMA, re-solve Eq. (10) after each observation.
    """

    def __init__(self, params: SystemParams, ema: float = 0.3):
        self.p = dataclasses.replace(params)
        self.ema = ema
        #: EMA of the step-path stall fraction (0..1) observed by the
        #: StepTimeline — 0.0 keeps Eq. (10) untouched, so runs without
        #: the observability pipeline behave exactly as before
        self.stall_fraction = 0.0

    def _fold(self, attr: str, value: float):
        old = getattr(self.p, attr)
        setattr(self.p, attr, (1 - self.ema) * old + self.ema * value)

    def observe_failure_gap(self, gap: float):
        self._fold("M", gap)

    def observe_write_bandwidth(self, bw: float):
        self._fold("W", bw)

    def observe_merge_time(self, t: float):
        self._fold("R_D", t)

    def observe_full_size(self, s: float):
        self._fold("S", s)

    def observe_stall_fraction(self, frac: float):
        """Fold in the timeline's attributed stall share of step wall.
        Unlike raw wall-clock (which conflates checkpoint cost with
        compute jitter), this is exactly the fraction of step time the
        persistence pipeline *caused*, so it modulates the effective
        write bandwidth Eq. (10) sees: a pipeline stalling the step
        loop looks slower than its raw device-to-storage rate."""
        frac = min(max(float(frac), 0.0), 1.0)
        self.stall_fraction = ((1 - self.ema) * self.stall_fraction
                               + self.ema * frac)

    def current(self) -> Tuple[int, int]:
        if self.stall_fraction <= 0.0:
            return practical_config(self.p)
        # penalize W by the observed stall share (bounded at 2x so a
        # pathological window cannot collapse the checkpoint frequency)
        eff = dataclasses.replace(
            self.p, W=self.p.W / (1.0 + min(self.stall_fraction, 1.0)))
        return practical_config(eff)
