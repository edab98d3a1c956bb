"""The port's remote object-store tier against the JAX reference's: the
same tree gives the same chunk sequence, index sizes and sha256s, and
the same range patches; transient faults are retried up to
``RetryExhaustedError``, corrupt chunks are caught as ``ChecksumError``,
the index is the commit point, and recovery falls back past a full whose
chunks exhaust their retries (small trees, on the CPU)."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.checkpoint.remote import FakeObjectStore as JaxFake
from repro.checkpoint.remote import RemoteObjectBackend as JaxRemote
from repro_torch import tree_leaves
from repro_torch.checkpoint import io
from repro_torch.checkpoint.config import StoreConfig, TierSpec
from repro_torch.checkpoint.patchset import PatchSet
from repro_torch.checkpoint.remote import (ChecksumError, FakeObjectStore,
                                           FaultInjector,
                                           FilesystemObjectStore,
                                           RemoteObjectBackend,
                                           RetryExhaustedError,
                                           TransientStoreError,
                                           make_remote_backend)
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.core import recovery as rec
from repro_torch.core.lowdiff import LowDiff
from repro_torch.core.steps import init_state
from repro_torch.data.synthetic import make_batch
from repro_torch.models.registry import build_model
from test_torch_tiers import _assert_same, _content, _jax_tree, _torch_tree


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


def _fast(store, **kw):
    """A backend that does not sleep between retries."""
    return RemoteObjectBackend(store, backoff_s=0.0, **kw)


def _index(store, key):
    return json.loads(store.get_object(f"{key}/index.json").decode())


@pytest.mark.parametrize("chunk_bytes", [1000, 4096, 1 << 16, 1 << 22])
def test_frame_chunks_and_index_match_the_reference(chunk_bytes):
    """Chunk for chunk the same bytes (so the same sha256 and size
    lists); chunk names differ only in their generation."""
    c = _content(6)
    payload, extra = io.frame_payload(_torch_tree(c))
    jpayload, jextra = jio.frame_payload(_jax_tree(c))
    mine = [bytes(memoryview(b).cast("B")) if isinstance(b, np.ndarray)
            else bytes(b) for b in io.frame_chunks(payload, chunk_bytes,
                                                   extra)]
    theirs = [bytes(memoryview(b).cast("B")) if isinstance(b, np.ndarray)
              else bytes(b) for b in jio.frame_chunks(jpayload, chunk_bytes,
                                                      jextra)]
    assert mine == theirs
    assert all(len(b) <= chunk_bytes for b in mine)
    fake, jfake = FakeObjectStore(), JaxFake()
    n = RemoteObjectBackend(fake, chunk_bytes=chunk_bytes).put(
        "full_00000001", _torch_tree(c))
    jn = JaxRemote(jfake, chunk_bytes=chunk_bytes).put(
        "full_00000001", _jax_tree(c))
    idx, jidx = _index(fake, "full_00000001"), _index(jfake, "full_00000001")
    assert n == jn == idx["nbytes"] == jidx["nbytes"]
    assert idx["format"] == jidx["format"] == "frame"
    for ix in (idx, jidx):
        assert [e["name"] for e in ix["chunks"]] == [
            f"full_00000001/{ix['gen']}.{i:06d}.chunk"
            for i in range(len(ix["chunks"]))]
    assert [(e["sha256"], e["size"]) for e in idx["chunks"]] == \
        [(e["sha256"], e["size"]) for e in jidx["chunks"]]
    assert [e["sha256"] for e in idx["chunks"]] == [
        hashlib.sha256(b).hexdigest() for b in mine]


@pytest.mark.parametrize("fmt", ["frame", "npz"])
def test_each_package_reads_the_others_bucket(tmp_path, fmt):
    c = _content(7)
    JaxRemote(_jax_fs(tmp_path / "theirs"), chunk_bytes=4096,
              fmt=fmt).put("k", _jax_tree(c))
    RemoteObjectBackend(FilesystemObjectStore(str(tmp_path / "mine")),
                        chunk_bytes=4096, fmt=fmt).put("k", _torch_tree(c))
    got = _fast(FilesystemObjectStore(str(tmp_path / "theirs"))).get("k")
    _assert_same(got, _torch_tree(c))
    assert got["bf"].dtype == torch.bfloat16
    _assert_same(JaxRemote(_jax_fs(tmp_path / "mine")).get("k"),
                 _jax_tree(c))


def _jax_fs(path):
    from repro.checkpoint.remote import FilesystemObjectStore as JaxFS
    return JaxFS(str(path))


def test_range_patch_reputs_only_touched_chunks_as_the_reference():
    """A row patch re-puts the chunks it touches (and the header's),
    reuses every other chunk by name, and leaves the same sha256 list as
    the reference's patch of the same frame."""
    c = _content(8)
    fake, jfake = FakeObjectStore(), JaxFake()
    be = RemoteObjectBackend(fake, chunk_bytes=4096)
    jbe = JaxRemote(jfake, chunk_bytes=4096)
    be.put("full_00000001", _torch_tree(c))
    jbe.put("full_00000001", _jax_tree(c))
    before = _index(fake, "full_00000001")
    rows = np.full((3, 64), 2.5, np.float32)
    be.patch("full_00000001", PatchSet().add("a0", 150, rows, (300, 64)))
    from repro.checkpoint.patchset import PatchSet as JaxPatchSet
    jbe.patch("full_00000001", JaxPatchSet().add("a0", 150, rows,
                                                  (300, 64)))
    after, jafter = _index(fake, "full_00000001"), \
        _index(jfake, "full_00000001")
    assert [(e["sha256"], e["size"]) for e in after["chunks"]] == \
        [(e["sha256"], e["size"]) for e in jafter["chunks"]]
    reused = [a["name"] == b["name"]
              for a, b in zip(after["chunks"], before["chunks"])]
    assert 0 < reused.count(False) <= 4 and reused.count(True) > 20
    w = c["w"].copy()
    w[150:153] = 2.5
    np.testing.assert_array_equal(be.get("full_00000001")["w"], w)
    assert be.verify("full_00000001") is None
    # the superseded chunks were swept: only the live index's remain
    live = {e["name"] for e in after["chunks"]}
    assert set(fake.list_objects("full_00000001/")) == \
        live | {"full_00000001/index.json"}


def test_npz_blobs_are_not_patched():
    be = RemoteObjectBackend(FakeObjectStore(), chunk_bytes=4096, fmt="npz")
    be.put("k", _torch_tree(_content(9)))
    with pytest.raises(ValueError, match="npz"):
        be.patch("k", PatchSet().add("a1", 0, np.zeros(7, np.float32)))


# ----------------------------------------------------------------------
# faults, retries, checksums
# ----------------------------------------------------------------------

def test_transient_faults_are_retried_then_exhausted():
    c = _content(10)
    fake = FakeObjectStore(FaultInjector(drop_puts=2, drop_gets=2))
    be = _fast(fake, chunk_bytes=1 << 16, max_retries=2)
    be.put("k", _torch_tree(c))
    _assert_same(be.get("k"), _torch_tree(c))
    assert be.stats()["retries"] == 4
    fake.faults = FaultInjector(drop_puts=3)
    with pytest.raises(RetryExhaustedError) as ei:
        be.put("k2", _torch_tree(c))
    assert isinstance(ei.value.__cause__, TransientStoreError)
    assert not be.exists("k2")
    fake.faults = FaultInjector(drop_gets=3)
    with pytest.raises(RetryExhaustedError):
        be.get("k")


def test_corrupt_chunk_is_a_checksum_error():
    """A flipped byte in flight is refetched; one that stays flipped
    through the retries exhausts them with ChecksumError as the cause,
    and verify() reports the corrupt stored chunk."""
    c = _content(11)
    fake = FakeObjectStore(FaultInjector(flip_gets=1))
    be = _fast(fake, chunk_bytes=1 << 16, max_retries=1)
    be.put("k", _torch_tree(c))
    _assert_same(be.get("k"), _torch_tree(c))
    assert be.stats()["checksum_failures"] == 1
    fake.faults = FaultInjector(flip_gets=2)
    with pytest.raises(RetryExhaustedError) as ei:
        be.get("k")
    assert isinstance(ei.value.__cause__, ChecksumError)
    fake.faults = None
    name = _index(fake, "k")["chunks"][1]["name"]
    data = fake._objects[name]
    fake._objects[name] = data[:10] + bytes([data[10] ^ 1]) + data[11:]
    assert "sha256 mismatch" in be.verify("k")


def test_missing_blob_is_not_retried():
    be = _fast(FakeObjectStore())
    with pytest.raises(FileNotFoundError):
        be.get("nope")
    assert be.stats()["retries"] == 0 and not be.exists("nope")


def test_the_index_is_the_commit_point(tmp_path):
    """An upload that dies before its index leaves the key invisible; a
    re-put that dies so keeps the previous version readable."""
    fs = FilesystemObjectStore(str(tmp_path))
    be = _fast(fs, chunk_bytes=4096)
    be.put("k", _torch_tree(_content(12)))
    orig = fs.put_object

    def failing(name, data):
        if name.endswith("index.json"):
            raise OSError("killed before the commit point")
        orig(name, data)

    fs.put_object = failing
    for key in ("new", "k"):
        with pytest.raises(OSError):
            be.put(key, _torch_tree(_content(13)))
    fs.put_object = orig
    assert not be.exists("new") and be.keys() == ["k"]
    _assert_same(be.get("k"), _torch_tree(_content(12)))
    assert be.sweep_orphans(0.0) > 0
    assert fs.list_objects("new/") == []
    _assert_same(be.get("k"), _torch_tree(_content(12)))


def test_make_remote_backend_urls(tmp_path):
    a = make_remote_backend("fake://shared-bucket", fault_rate=0.5)
    b = make_remote_backend("fake://shared-bucket")
    assert a.store is b.store and a.store.faults is None
    f = make_remote_backend(f"file://{tmp_path}")
    assert f.persist_root == str(tmp_path)
    assert f.store.root == os.path.join(str(tmp_path), "objects")
    for bad in ("s3://bucket", "no-scheme", "file://"):
        with pytest.raises(ValueError):
            make_remote_backend(bad)


# ----------------------------------------------------------------------
# recovery through the remote tier
# ----------------------------------------------------------------------

@pytest.mark.parametrize("loader", ["load_latest_chain", "load_latest_state"])
def test_recovery_skips_a_full_whose_chunks_exhaust_their_retries(
        tmp_path, loader):
    """The newest full's chunks are corrupt in the bucket: every fetch
    fails its checksum until the retries run out, and recovery falls
    back to the older full (and its differentials) instead of failing."""
    cfg = StoreConfig(str(tmp_path), tiers=[TierSpec(
        "remote", chunk_mb=1 / 64, max_retries=1)])
    store = cfg.build()
    old = {"params": {"w": np.arange(64, dtype=np.float32)}, "step": 4}
    store.save_full(4, old)
    store.save_diff(5, {"w": np.ones(3, np.float32)})
    store.save_full(6, {"params": {"w": np.zeros(64, np.float32)},
                        "step": 6})
    store.close()
    objects = os.path.join(str(tmp_path), "objects", "full_00000006")
    for f in os.listdir(objects):
        if f.endswith(".chunk"):
            p = os.path.join(objects, f)
            data = open(p, "rb").read()
            open(p, "wb").write(bytes([data[0] ^ 0xFF]) + data[1:])
    store = cfg.build()      # fresh RAM tier: reads go to the bucket
    if loader == "load_latest_chain":
        state, diffs = rec.load_latest_chain(store)
        assert [s for s, _ in diffs] == [5]
    else:
        state, step = store.load_latest_state()
        assert step == 4
    assert state["step"] == 4
    np.testing.assert_array_equal(state["params"]["w"], old["params"]["w"])
    store.close()


class _FaultyBucket(FilesystemObjectStore):
    """A directory bucket whose transfers go through a FaultInjector."""

    def __init__(self, root, faults):
        super().__init__(root)
        self.faults = faults

    def put_object(self, name, data):
        self.faults.on_put(name)
        super().put_object(name, data)

    def get_object(self, name):
        return self.faults.on_get(name, super().get_object(name))


def _lowdiff(store, recovery_store=None):
    """Train 7 steps over ``store``, then recover by device replay (from
    ``recovery_store`` when given: a fresh stack over the same bucket)."""
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    strat = LowDiff(model, store, full_interval=4, batch_size=2,
                    replay_device=True, device="cpu")
    state = init_state(model, 5, device="cpu")
    for t in range(7):
        state, _ = strat.train_step(state, make_batch(cfg, 64, 2, step=t))
    strat.flush()
    if recovery_store is not None:
        strat.close()
        strat = LowDiff(model, recovery_store(), full_interval=4,
                        batch_size=2, replay_device=True, device="cpu")
    got, n = strat.recover()
    strat.close()
    return state, got, n


def test_lowdiff_through_a_faulted_remote_recovers_bitwise(tmp_path):
    """LowDiff over RAM tier + a bucket that drops puts and gets and
    flips chunks in flight: a fresh stack (empty RAM tier, so every read
    crosses the faulty wire) recovers by device replay the trained state
    bit for bit, as over the local tier."""
    from repro_torch.checkpoint.backends import MemoryTierBackend
    _, want, n = _lowdiff(CheckpointStore(str(tmp_path / "local")))
    root = str(tmp_path / "remote")
    remotes = []

    def stack(faults):
        remotes.append(_fast(_FaultyBucket(os.path.join(root, "objects"),
                                           faults),
                             chunk_bytes=1 << 16, max_retries=8,
                             journal_root=root))
        return CheckpointStore(backend=MemoryTierBackend(remotes[-1]))

    trained, got, m = _lowdiff(
        stack(FaultInjector(drop_puts=3, rate=0.02, seed=11)),
        lambda: stack(FaultInjector(drop_gets=3, flip_gets=3, rate=0.02,
                                    seed=12)))
    assert n == m == 3
    writer, reader = (r.stats() for r in remotes)
    assert writer["retries"] > 0 and writer["bytes_down"] == 0
    assert reader["retries"] > 0 and reader["checksum_failures"] >= 3
    leaves = lambda s: tree_leaves((s["params"], s["opt"]))  # noqa: E731
    for a, b, t in zip(leaves(got), leaves(want), leaves(trained)):
        assert torch.equal(a, b) and torch.equal(a, t)
