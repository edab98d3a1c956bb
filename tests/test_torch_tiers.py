"""The port's storage tiers against the JAX reference's: every tier stack
serves the same trees (f32, bf16, scalar, NamedTuple, RowUpdate and
QuantSpan leaves) in both formats, shard files are byte-identical to the
reference's, the memory tier owns its bytes, evicts by size class and
policy and never the protected chain, a failed write-back surfaces from
``flush()``, the declarative configuration equals the reference's, and
the CLI recovers through each backend (small trees, on the CPU)."""
import json
import logging
import os
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.backends import ShardedBackend as JaxSharded
from repro.checkpoint.config import StoreConfig as JaxStoreConfig
from repro.checkpoint.config import TierSpec as JaxTierSpec
from repro.checkpoint.patchset import RowUpdate as JaxRowUpdate
from repro.compression.quant_span import QuantSpan as JaxQuantSpan
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.optim.adam import AdamState as JaxAdam
from repro_torch.checkpoint import io
from repro_torch.checkpoint.backends import (LocalFSBackend,
                                             MemoryTierBackend,
                                             ShardedBackend, make_backend)
from repro_torch.checkpoint.config import (StoreConfig, StoreConfigError,
                                           TierSpec)
from repro_torch.checkpoint.journal import ManifestJournal, MemoryJournal
from repro_torch.checkpoint.patchset import PatchSet, RowUpdate
from repro_torch.checkpoint.remote import RetryExhaustedError
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.compression.quant_span import QuantSpan
from repro_torch.core import recovery as rec
from repro_torch.launch.train import build_parser, run
from repro_torch.optim.adam import AdamState


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite's parallel workers
    would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ----------------------------------------------------------------------
# trees: the same numpy content as the port's and the reference's tree
# ----------------------------------------------------------------------

def _content(seed: int):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(300, 64), "b": f(7), "bf": f(256, 160), "mu": f(300, 64),
            "nu": f(300, 64), "count": seed + 3, "rows": [f(3, 64), f(2, 64)],
            "q": f(5, 64)}


def _torch_tree(c):
    """Payload order: a0 = w, a1 = b, a2 = bf (its uint16 view)."""
    return {"w": torch.from_numpy(c["w"].copy()),
            "b": torch.from_numpy(c["b"].copy()),
            "bf": torch.from_numpy(c["bf"]).to(torch.bfloat16),
            "opt": AdamState({"w": torch.from_numpy(c["mu"].copy())},
                             {"w": torch.from_numpy(c["nu"].copy())},
                             torch.tensor(c["count"], dtype=torch.int32)),
            "step": 5, "lr": 0.5, "tag": None,
            "ru": RowUpdate(np.array([0, 10], np.int64), list(c["rows"]),
                            (300, 64)),
            "qs": QuantSpan.from_rows([4], [c["q"]], (300, 64), bits=4)}


def _jax_tree(c):
    return {"w": jnp.asarray(c["w"]), "b": jnp.asarray(c["b"]),
            "bf": jnp.asarray(c["bf"], jnp.bfloat16),
            "opt": JaxAdam({"w": jnp.asarray(c["mu"])},
                           {"w": jnp.asarray(c["nu"])},
                           jnp.asarray(c["count"], jnp.int32)),
            "step": 5, "lr": 0.5, "tag": None,
            "ru": JaxRowUpdate(np.array([0, 10], np.int64), list(c["rows"]),
                               (300, 64)),
            "qs": JaxQuantSpan.from_rows([4], [c["q"]], (300, 64), bits=4)}


def _bits(x) -> np.ndarray:
    """Host bytes of a leaf, bf16 as its uint16 pattern."""
    if isinstance(x, torch.Tensor):
        return io.to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _flat(tree, path=""):
    """(path, kind, dtype, bits) records of a tree of either package."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (QuantSpan, JaxQuantSpan)):
        yield path, "qspan", (tuple(tree.starts), tuple(tree.shape),
                              tree.bits, tree.dtype), None
        for i, (q, s) in enumerate(zip(tree.qs, tree.scales)):
            yield from _flat({"q": q, "s": s}, f"{path}/{i}")
    elif hasattr(tree, "_fields"):
        yield path, type(tree).__name__, None, None
        for f in tree._fields:
            yield from _flat(getattr(tree, f), f"{path}/{f}")
    elif isinstance(tree, (list, tuple)):
        yield path, type(tree).__name__, len(tree), None
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    elif isinstance(tree, (torch.Tensor, np.ndarray, np.generic, jnp.ndarray)):
        a = _bits(tree)
        bf16 = (isinstance(tree, torch.Tensor)
                and tree.dtype == torch.bfloat16) or \
            np.asarray(tree).dtype == ml_dtypes.bfloat16
        yield path, "bf16" if bf16 else "arr", (a.dtype.str, a.shape), \
            a.tobytes()
    else:
        yield path, "py", tree, None


def _assert_same(got, want):
    assert list(_flat(got)) == list(_flat(want))


def _assert_port_types(tree):
    assert tree["bf"].dtype == torch.bfloat16
    assert isinstance(tree["opt"], AdamState)
    assert isinstance(tree["ru"], RowUpdate)
    assert isinstance(tree["qs"], QuantSpan)


# ----------------------------------------------------------------------
# tier stacks
# ----------------------------------------------------------------------

CHUNK_MB = 1 / 256      # 4 KiB chunks: every blob spans many objects

STACKS = {
    "local": lambda tmp: [TierSpec("local")],
    "memory": lambda tmp: [TierSpec("memory")],
    "memory+local": lambda tmp: [TierSpec("memory", capacity_mb=0.5),
                                 TierSpec("local")],
    "sharded": lambda tmp: [TierSpec("sharded", shards=3)],
    "remote-fake": lambda tmp: [TierSpec(
        "remote", url=f"fake://{os.path.basename(tmp)}", chunk_mb=CHUNK_MB)],
    "remote-file": lambda tmp: [TierSpec(
        "remote", url=f"file://{tmp}/bucket", chunk_mb=CHUNK_MB)],
}
CASES = [(s, f) for s in STACKS for f in ("frame", "npz")
         if not (s == "memory" and f == "npz")]


def _config(stack: str, tmp, fmt: str) -> StoreConfig:
    root = None if stack == "memory" else str(tmp / "root")
    return StoreConfig(root, tiers=STACKS[stack](tmp), fmt=fmt)


def _tiers(backend):
    """The backend and every tier below it, hot to cold."""
    while backend is not None:
        yield backend
        backend = getattr(backend, "lower", None)


def _patch(c):
    """Rows of a0 (w) from a RowUpdate and a dequantized QuantSpan, and
    rows of a2 (bf, uint16 view); returns (PatchSet, patched content)."""
    rng = np.random.default_rng(99)
    ru = RowUpdate(np.array([3, 200], np.int64),
                   [rng.standard_normal((2, 64)).astype(np.float32),
                    rng.standard_normal((5, 64)).astype(np.float32)],
                   (300, 64))
    qs = QuantSpan.from_rows(
        [40], [rng.standard_normal((6, 64)).astype(np.float32)], (300, 64),
        bits=8)
    bf_rows = torch.from_numpy(rng.standard_normal((4, 160)).astype(
        np.float32)).to(torch.bfloat16)
    ps = PatchSet().add_spans("a0", ru.spans() + qs.spans(), (300, 64))
    ps.add("a2", 100, io.to_numpy(bf_rows), (256, 160))
    c = dict(c, w=c["w"].copy(), bf=c["bf"].copy())
    for sp in ps["a0"]:
        c["w"][sp.start:sp.stop] = sp.data
    c["bf"][100:104] = bf_rows.float().numpy()
    return ps, c


@pytest.mark.parametrize("stack,fmt", CASES)
def test_tier_conformance(tmp_path, stack, fmt):
    """put / get / exists / keys / verify / patch / delete through the
    stack and through each tier below it, after flush()."""
    be = _config(stack, tmp_path, fmt).build_backend()
    c0, c1 = _content(0), _content(1)
    assert be.put("full_00000001", _torch_tree(c0)) > 0
    assert be.put("diff_00000002", _torch_tree(c1)) > 0
    be.flush()
    for tier in _tiers(be):
        assert tier.exists("full_00000001") and not tier.exists("nope")
        assert tier.keys() == ["diff_00000002", "full_00000001"]
        got = tier.get("full_00000001")
        _assert_port_types(got)
        _assert_same(got, _torch_tree(c0))
        assert tier.verify("full_00000001") is None
        with pytest.raises(FileNotFoundError):
            tier.get("nope")
    ps, patched = _patch(c0)
    if fmt == "frame":
        be.patch("full_00000001", ps)
        be.flush()
        for tier in _tiers(be):
            _assert_same(tier.get("full_00000001"), _torch_tree(patched))
            assert tier.verify("full_00000001") is None
    else:
        # npz members cannot be rewritten in place: refused, through the
        # write-back when a RAM tier sits on top, never swallowed
        with pytest.raises((ValueError, RuntimeError)):
            be.patch("full_00000001", ps)
            be.flush()
    be.delete("diff_00000002")
    for tier in _tiers(be):
        assert not tier.exists("diff_00000002")
        assert tier.keys() == ["full_00000001"]
        with pytest.raises(FileNotFoundError):
            tier.get("diff_00000002")
    if fmt == "frame":
        be.close()


@pytest.mark.parametrize("stack,fmt", [
    (s, f) for s, f in CASES if s not in ("memory", "remote-fake")])
def test_each_package_reads_the_others_tier(tmp_path, stack, fmt):
    """The same stack declared in both packages (the in-process stores
    are private to their package): what the reference writes the port
    reads, and the other way round."""
    c = _content(2)
    mine = _config(stack, tmp_path / "mine", fmt)
    theirs = JaxStoreConfig.from_dict(
        _config(stack, tmp_path / "theirs", fmt).to_dict())
    jbe = theirs.build_backend()
    jbe.put("full_00000001", _jax_tree(c))
    jbe.close()
    be = mine.build_backend()
    be.put("full_00000001", _torch_tree(c))
    be.close()
    got = StoreConfig.from_dict(theirs.to_dict()).build_backend().get(
        "full_00000001")
    _assert_port_types(got)
    _assert_same(got, _torch_tree(c))
    _assert_same(JaxStoreConfig.from_dict(mine.to_dict()).build_backend()
                 .get("full_00000001"), _jax_tree(c))


# ----------------------------------------------------------------------
# sharded: the reference's shard files
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["frame", "npz"])
def test_shard_files_match_the_reference(tmp_path, fmt):
    """Frame shards are byte-identical and the meta JSON equal once
    parsed; npz shards (zip timestamps) decode to equal arrays."""
    c = _content(3)
    mine = ShardedBackend(str(tmp_path / "mine"), 3, fmt=fmt)
    theirs = JaxSharded(str(tmp_path / "theirs"), 3, fmt=fmt)
    n = mine.put("full_00000004", _torch_tree(c))
    jn = theirs.put("full_00000004", _jax_tree(c))
    with open(mine._meta_path("full_00000004")) as f:
        meta = json.load(f)
    with open(theirs._meta_path("full_00000004")) as f:
        assert meta == json.load(f)
    assert {p["kind"] for p in meta["placements"]} == {"split", "whole"}
    assert meta["shards"] == [0, 1, 2]
    for k in meta["shards"]:
        a, b = mine._find_shard(k, "full_00000004"), \
            theirs._find_shard(k, "full_00000004")
        if fmt == "frame":
            assert open(a, "rb").read() == open(b, "rb").read()
        else:
            za, zb = io.load_npz(a), io.load_npz(b)
            assert sorted(za) == sorted(zb)
            for name in za:
                np.testing.assert_array_equal(za[name], zb[name])
    if fmt == "frame":
        assert n == jn
    mine.close()
    theirs.close()


def test_sharded_patch_writes_only_the_shards_it_touches(tmp_path):
    be = ShardedBackend(str(tmp_path), 3)
    c = _content(4)
    be.put("full_00000001", _torch_tree(c))
    before = {k: open(be._find_shard(k, "full_00000001"), "rb").read()
              for k in range(3)}
    ps = PatchSet().add("a0", 0, np.ones((5, 64), np.float32), (300, 64))
    be.patch("full_00000001", ps)
    after = {k: open(be._find_shard(k, "full_00000001"), "rb").read()
             for k in range(3)}
    assert before[0] != after[0]
    changed = [k for k in range(3) if before[k] != after[k]]
    assert changed == [0]
    w = c["w"].copy()
    w[:5] = 1.0
    np.testing.assert_array_equal(be.get("full_00000001")["w"], w)
    assert be.verify("full_00000001") is None
    be.close()


# ----------------------------------------------------------------------
# memory tier
# ----------------------------------------------------------------------

def test_memory_tier_copies_on_put_and_on_get(tmp_path):
    """The tier owns its bytes: a source buffer overwritten after put
    (as the caching host allocator reuses a snapshot's pinned block)
    changes neither the resident blob nor its write-back, and mutating
    a tree ``get`` returned changes neither."""
    be = MemoryTierBackend(LocalFSBackend(str(tmp_path)))
    c = _content(5)
    src = _torch_tree(c)
    be.put("full_00000001", src)
    src["w"].fill_(7.0)
    src["bf"].fill_(3.0)
    src["opt"].mu["w"].zero_()
    got = be.get("full_00000001")
    _assert_same(got, _torch_tree(c))
    got["w"][:] = -1.0
    got["bf"].fill_(-2.0)
    _assert_same(be.get("full_00000001"), _torch_tree(c))
    be.flush()
    _assert_same(be.lower.get("full_00000001"), _torch_tree(c))
    be.close()


@pytest.mark.parametrize("lower", [False, True], ids=["ram", "ram+local"])
def test_memory_tier_keeps_an_owned_full_uncopied(tmp_path, lower):
    """``put_owned``: the caller hands its host arrays over (as LowDiff
    hands over a full's snapshot), and the tier keeps them uncopied and
    serves, writes back and evicts them as any blob; ``put`` still
    copies, and a backend without a RAM tier writes as ``put``."""
    be = MemoryTierBackend(LocalFSBackend(str(tmp_path)) if lower
                           else None)
    c = _content(6)
    src = _torch_tree(c)
    be.put_owned("full_00000001", src)
    _, arrays, _ = be._mem["full_00000001"]
    assert any(np.shares_memory(a, src["w"].numpy()) for a in arrays)
    _assert_same(be.get("full_00000001"), _torch_tree(c))
    be.put("full_00000002", _torch_tree(c))
    _, arrays, _ = be._mem["full_00000002"]
    assert not any(np.shares_memory(a, src["w"].numpy()) for a in arrays)
    if lower:
        be.flush()
        _assert_same(be.lower.get("full_00000001"), _torch_tree(c))
    be.delete("full_00000001")
    assert not be.exists("full_00000001")
    be.close()
    local = LocalFSBackend(str(tmp_path / "plain"))
    local.put_owned("full_00000003", _torch_tree(c))
    _assert_same(local.get("full_00000003"), _torch_tree(c))


def test_lowdiff_hands_its_full_snapshot_to_the_store(tmp_path,
                                                      monkeypatch):
    """LowDiff's full persists through ``put_owned`` (its snapshot's host
    blocks are private to it), so the RAM tier holds the snapshot's own
    arrays, and the chain still recovers the trained state bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.lowdiff import LowDiff
    from repro_torch.core.steps import init_state
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.registry import build_model
    owned = []
    real = MemoryTierBackend.put_owned
    monkeypatch.setattr(MemoryTierBackend, "put_owned",
                        lambda self, k, o: owned.append(k) or
                        real(self, k, o))
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    store = StoreConfig(tiers=[TierSpec(kind="memory")],
                        retention_fulls=1).build()
    strat = LowDiff(model, store, full_interval=2, batch_size=2,
                    parallel_recovery=False, device="cpu")
    state = init_state(model, 0, mode="lowdiff", device="cpu")
    stream = TokenStream(cfg, 16, 2, seed=0, device="cpu")
    for _ in range(5):
        state, _ = strat.train_step(state, next(stream))
    strat.flush()
    assert owned == ["full_00000002", "full_00000004"]
    got, applied = strat.recover()
    assert applied == 1
    for a, b in zip(rec.tree_leaves(got["params"]),
                    rec.tree_leaves(state["params"])):
        assert torch.equal(a, b)
    strat.close()


def _blob(nbytes: int, v: float):
    return {"g": np.full(nbytes // 4, v, np.float32)}


@pytest.mark.parametrize("policy,victim", [("fifo", "a"), ("lru", "b")])
def test_memory_tier_eviction_policy(tmp_path, policy, victim):
    """Within a size class, fifo evicts the oldest put and lru the least
    recently read."""
    be = MemoryTierBackend(LocalFSBackend(str(tmp_path)),
                           capacity_bytes=2 * 4096 + 100, eviction=policy)
    be.put("a", _blob(4096, 1.0))
    be.put("b", _blob(4096, 2.0))
    be.get("a")
    be.put("c", _blob(4096, 3.0))
    with be._lock:
        resident = set(be._mem)
    assert resident == {"a", "b", "c"} - {victim}
    assert be.evictions == 1
    np.testing.assert_array_equal(be.get(victim)["g"],
                                  _blob(4096, {"a": 1.0, "b": 2.0}[victim])
                                  ["g"])
    be.close()


def test_memory_tier_evicts_the_fullest_size_class_first(tmp_path):
    """One large blob goes before several small ones that are older."""
    be = MemoryTierBackend(LocalFSBackend(str(tmp_path)),
                           capacity_bytes=40_000)
    for i in range(4):
        be.put(f"small{i}", _blob(2048, float(i)))
    be.put("large", _blob(32768, 9.0))
    be.put("small4", _blob(2048, 4.0))
    with be._lock:
        resident = set(be._mem)
    assert "large" not in resident
    assert {f"small{i}" for i in range(5)} <= resident
    assert be.stats()["size_classes"] == 1
    be.close()


def test_memory_tier_never_evicts_the_protected_chain(tmp_path):
    """The newest full's chain stays resident past capacity (recovery
    reads it from RAM even with the lower tier's files gone); the older
    chain is evicted only after its write-back landed."""
    low = str(tmp_path / "low")
    be = MemoryTierBackend(LocalFSBackend(low), capacity_bytes=48 * 1024)
    store = CheckpointStore(backend=be)
    pay = lambda s: {"g": np.full(4096, float(s), np.float32)}  # noqa: E731
    store.save_full(2, {"params": pay(2), "step": np.int32(2)})
    for s in (3, 4):
        store.save_diff(s, pay(s))
    store.save_full(5, {"params": pay(5), "step": np.int32(5)})
    for s in (6, 7, 8, 9):
        store.save_diff(s, pay(s))
    store.flush()
    chain = {"full_00000005"} | {f"diff_{s:08d}" for s in (6, 7, 8, 9)}
    with be._lock:
        resident = set(be._mem)
    assert chain <= resident
    assert be.evictions > 0 and not resident & {"full_00000002"}
    assert LocalFSBackend(low).exists("full_00000002")  # written back
    for f in os.listdir(low):
        if f.endswith(".ckpt"):
            os.unlink(os.path.join(low, f))
    state, diffs = rec.load_latest_chain(store)
    assert int(state["step"]) == 5
    assert [s for s, _ in diffs] == [6, 7, 8, 9]
    store.close()


def test_a_concurrent_writer_keeps_the_incoming_full_protected(tmp_path):
    """LowDiff persists fulls on two workers. While full 4's put runs,
    the other worker journals full 2 and applies full 2's chain: full 4
    must stay protected, so the tier evicts full 2 (once written back)
    and the newest full stays resident for recovery."""
    def pay(s):
        return {"params": np.full(4096, float(s), np.float32)}

    class Interleaved(MemoryTierBackend):
        def put(self, key, obj):
            if key == "full_00000004":
                store.save_full(2, pay(2))
            return super().put(key, obj)

    be = Interleaved(LocalFSBackend(str(tmp_path)), capacity_bytes=24 * 1024)
    store = CheckpointStore(backend=be)
    store.save_full(4, pay(4))
    store.flush()
    with be._lock:
        resident = set(be._mem)
    assert resident == {"full_00000004"} and be.evictions == 1
    assert be.lower.exists("full_00000002")
    state, diffs = rec.load_latest_chain(store)
    np.testing.assert_array_equal(state["params"], pay(4)["params"])
    store.close()


def test_memory_tier_capacity_needs_a_lower_tier():
    with pytest.raises(ValueError, match="lower"):
        MemoryTierBackend(None, capacity_bytes=1024)
    with pytest.raises(StoreConfigError, match="spill"):
        StoreConfig(None, tiers=[TierSpec("memory", capacity_mb=1)]).build()


def test_memory_tier_flush_raises_a_failed_writeback(tmp_path):
    """A failed write-back raises from flush() even after the next put
    reaped its future."""
    class FailingLower(LocalFSBackend):
        def put(self, key, obj):
            if key == "k1":
                raise RetryExhaustedError(f"remote down for {key}")
            return super().put(key, obj)

    be = MemoryTierBackend(FailingLower(str(tmp_path)))
    be.put("k1", _blob(64, 1.0))
    deadline = time.monotonic() + 10.0
    while not be._inflight["k1"].done():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    be.put("k2", _blob(64, 2.0))
    with pytest.raises(RuntimeError, match="write-back") as ei:
        be.flush()
    assert isinstance(ei.value.__cause__, RetryExhaustedError)
    assert be.stats()["writeback_errors"] == 1


def test_journal_follows_the_backend(tmp_path):
    assert isinstance(StoreConfig(None, tiers=[TierSpec("memory")])
                      .build().journal, MemoryJournal)
    store = StoreConfig(str(tmp_path), tiers=[
        TierSpec("memory"), TierSpec("local")]).build()
    assert isinstance(store.journal, ManifestJournal)
    assert store.backend.provenance == "memory"
    store.save_full(1, {"params": np.zeros(4, np.float32)})
    assert store.manifest["fulls"][0]["tier"] == "memory"
    store.close()


def test_npz_store_refuses_patches(tmp_path):
    """Incremental persistence patches frames in place: an npz store
    refuses it, and LowDiff+ says so when it is built."""
    from repro_torch.configs import get_config
    from repro_torch.core.lowdiff_plus import LowDiffPlus
    from repro_torch.models.registry import build_model
    store = StoreConfig(str(tmp_path), fmt="npz").build()
    with pytest.raises(ValueError, match="frame"):
        store.save_patch(2, "full_00000001", {"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="frame format"):
        LowDiffPlus(build_model(get_config("gpt2-l").reduced()), store,
                    persist_mode="incremental", device="cpu")
    store.close()


# ----------------------------------------------------------------------
# declarative configuration against the reference's
# ----------------------------------------------------------------------

LEGACY = [("local", {}), ("local", {"fmt": "npz"}),
          ("memory", {"capacity_mb": 64.0, "eviction": "lru"}),
          ("memory", {}), ("sharded", {"shards": 3}),
          ("sharded", {"fmt": "npz"}),
          ("remote", {"remote_url": "fake://b", "chunk_mb": 1.0,
                      "max_retries": 2, "remote_fault_rate": 0.1}),
          ("remote", {"capacity_mb": 32.0, "compact_every": 8})]


@pytest.mark.parametrize("backend,kw", LEGACY)
@pytest.mark.parametrize("root", ["/ck", None])
def test_from_legacy_matches_the_reference(backend, kw, root):
    if root is None and backend in ("local", "sharded"):
        with pytest.raises(StoreConfigError, match="root"):
            StoreConfig.from_legacy(root, backend=backend, **kw)
        return
    if root is None and backend == "memory" and "capacity_mb" in kw:
        with pytest.raises(StoreConfigError, match="spill"):
            StoreConfig.from_legacy(root, backend=backend, **kw)
        return
    mine = StoreConfig.from_legacy(root, backend=backend, **kw)
    ref = JaxStoreConfig.from_legacy(root, backend=backend, **kw)
    assert mine.to_dict() == ref.to_dict()
    assert StoreConfig.from_dict(ref.to_dict()) == mine
    assert JaxStoreConfig.from_dict(mine.to_dict()).to_dict() == \
        ref.to_dict()
    assert json.loads(json.dumps(mine.to_dict())) == mine.to_dict()


BAD = [
    (lambda M: M[1]("local", capacity_mb=64.0).validate("tiers[0]"),
     "tiers[0].capacity_mb"),
    (lambda M: M[1]("memory", shards=8).validate("tiers[1]"),
     "tiers[1].shards"),
    (lambda M: M[1]("bogus").validate("tiers[0]"), "tiers[0].kind"),
    (lambda M: M[1].from_dict({"shards": 2}), "tier.kind: missing"),
    (lambda M: M[1].from_dict({"kind": "local", "nope": 1}, "tiers[0]"),
     "tiers[0].nope"),
    (lambda M: M[1]("memory", eviction="mru").validate("tiers[0]"),
     "tiers[0].eviction"),
    (lambda M: M[1]("remote", fault_rate=2.0).validate("tiers[0]"),
     "tiers[0].fault_rate"),
    (lambda M: M[0]("/t", tiers=[]).validate(), "tiers"),
    (lambda M: M[0]("/t", tiers=[M[1]("local"), M[1]("memory")])
     .validate(), "tiers[1].kind"),
    (lambda M: M[0]("/t", tiers=[M[1]("local"), M[1]("local")])
     .validate(), "duplicate kind"),
    (lambda M: M[0](None, tiers=[M[1]("sharded")]).validate(), "root"),
    (lambda M: M[0]("/t", fmt="xml").validate(), "fmt"),
    (lambda M: M[0]("/t", retention_fulls=-1).validate(),
     "retention_fulls"),
    (lambda M: M[0]("/t", compact_every=0).validate(), "compact_every"),
    (lambda M: M[0].from_dict({"root": "/t", "surprise": 1}),
     "surprise: unknown field"),
    (lambda M: M[0].from_legacy("/t", backend="tape"), "backend"),
]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_validation_names_the_same_field_as_the_reference(i):
    build, needle = BAD[i]
    msgs = []
    for pkg in ((StoreConfig, TierSpec), (JaxStoreConfig, JaxTierSpec)):
        with pytest.raises(ValueError) as ei:
            build(pkg)
        assert needle in str(ei.value), str(ei.value)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("build,field", [
    (lambda: StoreConfig("/t", tiers=[TierSpec("peer", replicas=2),
                                      TierSpec("local")]),
     "tiers[0].kind"),
    (lambda: StoreConfig.from_legacy("/t", peers=2), "tiers[0].kind"),
    (lambda: StoreConfig.from_dict({"root": "/t", "tiers": [
        {"kind": "peer", "hub": "h"}, {"kind": "local"}]}), "tiers[0].kind"),
    (lambda: StoreConfig("/t", retention_fulls=2), "retention_fulls"),
    (lambda: StoreConfig.from_legacy("/t", retention_fulls=1),
     "retention_fulls"),
    (lambda: StoreConfig("/t", host_id="h0"), "host_id"),
    (lambda: StoreConfig.from_legacy("/t", host_id="h1"), "host_id"),
])
def test_unported_settings_are_refused(build, field):
    """The settings that slice 5 refused (the peer tier, retention, the
    host id of the segmented journal) are ported: each validates, sets
    its field, and gives the reference's configuration dict."""
    cfg = build()
    cfg.validate()
    value = {"tiers[0].kind": lambda: cfg.tiers[0].kind,
             "retention_fulls": lambda: cfg.retention_fulls,
             "host_id": lambda: cfg.host_id}[field]()
    assert value in ("peer", 1, 2, "h0", "h1")
    ref = JaxStoreConfig.from_dict(cfg.to_dict())
    assert ref.to_dict() == cfg.to_dict()
    assert StoreConfig.from_dict(ref.to_dict()) == cfg


def test_make_backend_shim_composes_the_legacy_stacks(tmp_path):
    with pytest.warns(DeprecationWarning):
        be = make_backend("remote", str(tmp_path), capacity_mb=8.0)
    assert isinstance(be, MemoryTierBackend)
    assert be.lower.name == "remote" and be.capacity_bytes == 8 << 20
    assert be.lower.persist_root == str(tmp_path)
    be.close()
    with pytest.warns(DeprecationWarning):
        be = make_backend("memory", str(tmp_path), memory_spill=False)
    assert be.lower is None and be.persist_root is None
    with pytest.raises(ValueError, match="unknown backend"), \
            pytest.warns(DeprecationWarning):
        make_backend("tape", str(tmp_path))


def test_engine_config_nests_the_store_config(tmp_path):
    """EngineConfig.from_args builds the same StoreConfig as the
    reference's from the tier flags (test_torch_flag_config_sync holds
    each flag); without --ckpt-dir there is no store."""
    from argparse import Namespace
    from repro_torch.core.engine import EngineConfig
    ns = Namespace(ckpt_dir=str(tmp_path), backend="sharded", shards=2,
                   format="npz")
    mine, ref = EngineConfig.from_args(ns), JaxEngineConfig.from_args(ns)
    assert mine.store.to_dict() == ref.store.to_dict()
    assert EngineConfig.from_args(Namespace(ckpt_dir=None)).store is None
    assert EngineConfig.from_args(Namespace()).build_store() is None


# ----------------------------------------------------------------------
# the CLI through each backend
# ----------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--backend", "memory", "--memory-capacity-mb", "40"],
    ["--backend", "sharded", "--shards", "3"],
    ["--backend", "remote", "--remote-url", "fake://cli",
     "--remote-fault-rate", "0.02", "--chunk-mb", "0.25"],
    ["--backend", "remote"],
    ["--format", "npz"],
])
def test_train_cli_recovers_through_each_backend(tmp_path, extra):
    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    lines = Lines()
    logger = logging.getLogger("repro_torch")
    logger.addHandler(lines)
    try:
        losses, _ = run(build_parser().parse_args(
            ["--device", "cpu", "--arch", "gpt2-l", "--reduced", "--steps",
             "6", "--full-interval", "3", "--fail-at", "5", "--log-every",
             "0", "--ckpt-dir", str(tmp_path / "ck")] + extra))
    finally:
        logger.removeHandler(lines)
    assert any("recovered at step 5; resuming" in m for m in lines.lines)
    assert len(losses) == 6 and all(np.isfinite(losses))
