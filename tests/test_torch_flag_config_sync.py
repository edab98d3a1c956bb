"""Guard: the port's training flags and its engine configuration cannot
drift apart, and its LowDiff+, storage-tier, maintenance and peer flags
keep the reference's defaults and choices. Every ``repro_torch.launch.train``
flag is a runtime input (``RUNTIME_FLAGS``) or maps to a field of
``EngineConfig``, ``StoreConfig`` or a ``TierSpec`` through
``FLAG_MAP``, and every ``FLAG_MAP`` entry names a real flag."""
import dataclasses

import pytest

from repro.core.engine import EngineConfig as ReferenceEngineConfig
from repro.core.engine import FLAG_MAP as REFERENCE_FLAG_MAP
from repro.core.engine import STRATEGIES as REFERENCE_STRATEGIES
from repro.launch.train import build_parser as reference_parser
from repro_torch.checkpoint.config import StoreConfig, TierSpec
from repro_torch.core.engine import (FLAG_MAP, RUNTIME_FLAGS, STRATEGIES,
                                     ConfigError, EngineConfig)
from repro_torch.launch.train import build_parser

FIELDS = {f.name: f for f in dataclasses.fields(EngineConfig)}
STORE_FIELDS = {f.name: f for f in dataclasses.fields(StoreConfig)}
TIER_FIELDS = {f.name: f for f in dataclasses.fields(TierSpec)}
LOWDIFF_PLUS_FLAGS = ("persist_mode", "persist_threshold",
                      "dirty_granularity", "diff_quant", "fold_interval",
                      "fold_amplification")
TIER_FLAGS = ("backend", "format", "shards", "memory_capacity_mb",
              "eviction", "remote_url", "chunk_mb", "max_retries",
              "remote_fault_rate")
#: the eleven flags of the maintenance service, GC and the peer tier
MAINTENANCE_FLAGS = ("retention", "maintenance", "gc_slice", "merge_slice",
                     "scrub_interval", "host_id", "peers", "peer_hub",
                     "peer_domain", "peer_window", "peer_fault_rate")


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
        # ckpt_dir's default is the launcher's, and --backend names a
        # legacy tier list; the other store flags share their default
        assert field in STORE_FIELDS
        if dest not in ("ckpt_dir", "backend"):
            assert STORE_FIELDS[field].default == default
        return
    if scope.startswith("tier:"):
        assert scope[len("tier:"):] in ("peer", "memory", "sharded",
                                        "remote")
        # --peers counts the replicas and 0 means no peer tier: only a
        # positive count builds the tier, whose replicas default is 2
        if dest != "peers":
            assert TIER_FIELDS[field].default == default
        return
    assert scope == "engine" and field in FIELDS
    if dest in ("replay_device", "maintenance"):
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


@pytest.mark.parametrize("dest", TIER_FLAGS)
def test_tier_flags_match_the_reference(dest):
    mine = _actions(build_parser())[dest]
    ref = _actions(reference_parser())[dest]
    assert mine.default == ref.default
    assert mine.choices == ref.choices
    assert mine.type == ref.type
    assert mine.option_strings == ref.option_strings


@pytest.mark.parametrize("dest", MAINTENANCE_FLAGS)
def test_maintenance_flags_match_the_reference(dest):
    mine = _actions(build_parser())[dest]
    ref = _actions(reference_parser())[dest]
    assert mine.default == ref.default
    assert mine.choices == ref.choices
    assert mine.type == ref.type
    assert mine.option_strings == ref.option_strings
    assert FLAG_MAP[dest] == REFERENCE_FLAG_MAP[dest]


def test_maintenance_flags_reach_the_engine_and_store(tmp_path):
    argv = ["--ckpt-dir", str(tmp_path), "--backend", "memory",
            "--memory-capacity-mb", "64", "--peers", "2", "--peer-hub",
            "hub1", "--peer-domain", "rack1", "--peer-window", "4",
            "--peer-fault-rate", "0.1", "--retention", "3",
            "--maintenance", "on", "--gc-slice", "5", "--merge-slice", "6",
            "--scrub-interval", "2.5", "--host-id", "hostA"]
    mine = EngineConfig.from_args(build_parser().parse_args(argv))
    ref = ReferenceEngineConfig.from_args(reference_parser().parse_args(argv))
    assert (mine.maintenance, mine.gc_slice, mine.merge_slice,
            mine.scrub_interval) == (ref.maintenance, ref.gc_slice,
                                     ref.merge_slice, ref.scrub_interval) \
        == (True, 5, 6, 2.5)
    assert mine.store.to_dict() == ref.store.to_dict()
    assert [t.kind for t in mine.store.tiers] == ["peer", "memory", "local"]


@pytest.mark.parametrize("argv", [
    ["--backend", "local"],
    ["--backend", "local", "--format", "npz"],
    ["--backend", "memory", "--memory-capacity-mb", "64", "--eviction",
     "lru"],
    ["--backend", "sharded", "--shards", "3"],
    ["--backend", "remote", "--remote-url", "fake://bkt", "--chunk-mb",
     "0.5", "--max-retries", "2", "--remote-fault-rate", "0.1"],
    ["--backend", "remote", "--memory-capacity-mb", "32"],
])
def test_tier_flags_reach_the_store_config(tmp_path, argv):
    """The same flags give the same store configuration in both
    packages."""
    argv = argv + ["--ckpt-dir", str(tmp_path)]
    mine = EngineConfig.from_args(build_parser().parse_args(argv)).store
    ref = ReferenceEngineConfig.from_args(
        reference_parser().parse_args(argv)).store
    assert mine.to_dict() == ref.to_dict()


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
