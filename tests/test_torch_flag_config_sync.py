"""Guard: the port's training flags and its engine configuration cannot
drift apart, and its LowDiff+ flags keep the reference's defaults and
choices. Every ``repro_torch.launch.train`` flag is a runtime input
(``RUNTIME_FLAGS``) or maps to an ``EngineConfig`` field through
``FLAG_MAP``, and every ``FLAG_MAP`` entry names a real flag."""
import dataclasses

import pytest

from repro.launch.train import build_parser as reference_parser
from repro_torch.core.engine import (FLAG_MAP, RUNTIME_FLAGS, ConfigError,
                                     EngineConfig)
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
