"""The port's failure simulator against the reference's: the same
profiles and the same results, float for float, across seeds, and the
orderings of the paper's Exp. 3/9/10 (``tests/test_simulator.py``) on
the port's copy."""
import dataclasses

import numpy as np
import pytest

from repro.core import simulator as ref
from repro_torch.core.simulator import (SimResult, StrategyProfile,
                                        paper_profiles, simulate)

KW = [dict(iter_time=0.5, full_bytes=8.7e9, diff_bytes=5.4e7,
           compress_stall=0.15),
      dict(iter_time=0.5, full_bytes=1.4e9, diff_bytes=9.2e6),
      dict(iter_time=1.25, full_bytes=12.87e9, diff_bytes=2.76e8,
           write_bw=0.6e9, d2h_bw=6e9, compress_stall=0.04, batch_size=4,
           full_interval=7)]


@pytest.mark.parametrize("kw", range(len(KW)))
def test_profiles_equal_reference(kw):
    mine, theirs = paper_profiles(**KW[kw]), ref.paper_profiles(**KW[kw])
    assert list(mine) == list(theirs)
    for name in mine:
        assert dataclasses.asdict(mine[name]) == \
            dataclasses.asdict(theirs[name])


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
@pytest.mark.parametrize("kw", range(len(KW)))
def test_simulate_equals_reference_float_for_float(kw, seed):
    mine, theirs = paper_profiles(**KW[kw]), ref.paper_profiles(**KW[kw])
    for name in mine:
        for mtbf in (360.0, 1800.0, 7200.0):
            a = simulate(mine[name], run_iters=3000, mtbf_s=mtbf, seed=seed)
            b = ref.simulate(theirs[name], run_iters=3000, mtbf_s=mtbf,
                             seed=seed)
            assert isinstance(a, SimResult)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
            assert a.effective_ratio == b.effective_ratio


def _run(name, profiles, mtbf, iters=20000, seeds=3):
    rs = [simulate(profiles[name], run_iters=iters, mtbf_s=mtbf, seed=s)
          for s in range(seeds)]
    return float(np.mean([r.effective_ratio for r in rs]))


def test_lowdiff_beats_baselines_under_failures():
    profiles = paper_profiles(iter_time=0.5, full_bytes=8.7e9,
                              diff_bytes=5.4e7, compress_stall=0.15)
    mtbf = 1800.0
    r = {k: _run(k, profiles, mtbf) for k in
         ["full_sync", "checkfreq", "gemini", "naive_dc", "lowdiff",
          "lowdiff_plus_s"]}
    assert r["lowdiff"] > r["checkfreq"]
    assert r["lowdiff"] > r["naive_dc"]
    assert r["lowdiff_plus_s"] >= r["gemini"] - 0.01
    assert r["lowdiff"] > 0.9


def test_effective_ratio_decreases_with_failure_rate():
    profiles = paper_profiles(iter_time=0.5, full_bytes=1.4e9,
                              diff_bytes=9.2e6)
    assert _run("lowdiff", profiles, mtbf=7200) > \
        _run("lowdiff", profiles, mtbf=360)


def test_no_failures_no_waste():
    p = StrategyProfile("x", iter_time=0.1, ckpt_overhead=0.0,
                        ckpt_interval=1, restore_time=1.0)
    r = simulate(p, run_iters=1000, mtbf_s=1e12, seed=0)
    assert r.failures == 0
    assert abs(r.wasted_time) < 1e-6
