"""Guard: the port's training flags and its engine configuration cannot
drift apart, and its LowDiff+ flags keep the reference's defaults and
choices. Every ``repro_torch.launch.train`` flag is a runtime input
(``RUNTIME_FLAGS``) or maps to an ``EngineConfig`` field through
``FLAG_MAP``, and every ``FLAG_MAP`` entry names a real flag."""
import dataclasses

import pytest

from repro.core.engine import STRATEGIES as REFERENCE_STRATEGIES
from repro.launch.train import build_parser as reference_parser
from repro_torch.core.engine import (FLAG_MAP, RUNTIME_FLAGS, STRATEGIES,
                                     ConfigError, EngineConfig)
from repro_torch.launch.train import build_parser

FIELDS = {f.name: f for f in dataclasses.fields(EngineConfig)}
LOWDIFF_PLUS_FLAGS = ("persist_mode", "persist_threshold",
                      "dirty_granularity", "diff_quant", "fold_interval",
                      "fold_amplification")


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_every_flag_is_mapped_or_runtime():
    dests = set(_actions(build_parser()))
    assert not dests - RUNTIME_FLAGS - set(FLAG_MAP)
    assert not set(FLAG_MAP) - dests
    assert not RUNTIME_FLAGS & set(FLAG_MAP)


@pytest.mark.parametrize("dest", sorted(FLAG_MAP))
def test_flag_targets_a_config_field_with_its_default(dest):
    scope, field = FLAG_MAP[dest]
    default = _actions(build_parser())[dest].default
    if scope == "store":
        assert field in ("root", "fmt", "backend")
        return
    assert scope == "engine" and field in FIELDS
    if dest == "replay_device":
        default = default == "on"
    assert FIELDS[field].default == default


@pytest.mark.parametrize("dest", LOWDIFF_PLUS_FLAGS)
def test_lowdiff_plus_flags_match_the_reference(dest):
    mine = _actions(build_parser())[dest]
    ref = _actions(reference_parser())[dest]
    assert mine.default == ref.default
    assert mine.choices == ref.choices
    assert mine.type == ref.type
    assert mine.option_strings == ref.option_strings


def test_lowdiff_plus_flags_reach_the_engine():
    args = build_parser().parse_args(
        ["--strategy", "lowdiff_plus", "--persist-mode", "incremental",
         "--dirty-granularity", "row", "--diff-quant", "int4",
         "--persist-threshold", "0.5", "--fold-interval", "3",
         "--fold-amplification", "2.0"])
    cfg = EngineConfig.from_args(args)
    assert (cfg.strategy, cfg.persist_mode, cfg.dirty_granularity,
            cfg.diff_quant, cfg.persist_threshold, cfg.fold_interval,
            cfg.fold_amplification) == ("lowdiff_plus", "incremental",
                                        "row", "int4", 0.5, 3, 2.0)
    with pytest.raises(ConfigError, match="diff_quant"):
        dataclasses.replace(cfg, diff_quant="int2").validate()


def test_strategies_match_the_reference():
    """Every checkpointing strategy of the reference, the paper's
    baselines included, is a ``--strategy`` choice of the port."""
    assert STRATEGIES == REFERENCE_STRATEGIES
    mine = _actions(build_parser())["strategy"]
    ref = _actions(reference_parser())["strategy"]
    assert tuple(mine.choices) == tuple(ref.choices) == STRATEGIES
    assert mine.default == ref.default


@pytest.mark.parametrize("strategy,interval", [
    ("checkfreq", 10), ("gemini", 1), ("naive_dc", 1), ("full_sync", 6)])
def test_baselines_take_the_reference_knobs(tmp_path, strategy, interval):
    from repro_torch.configs import get_config
    from repro_torch.core.engine import make_engine
    from repro_torch.models.registry import build_model
    args = build_parser().parse_args(
        ["--strategy", strategy, "--full-interval", "6", "--rho", "0.05",
         "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    strat = make_engine(EngineConfig.from_args(args),
                        build_model(get_config("gpt2-l").reduced()))
    try:
        assert strat.name == strategy
        assert strat.interval == interval
        assert strat.device.type == "cpu"
        if strategy == "gemini":
            assert strat.persist_interval == 6
        if strategy == "naive_dc":
            assert (strat.rho, strat.full_interval) == (0.05, 6)
    finally:
        strat.close()
