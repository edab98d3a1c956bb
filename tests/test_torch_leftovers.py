"""The small functions of already-ported modules that the distributed
slice needs or that the reference's benchmarks read, against the JAX
reference: legacy dict patches (``PatchSet.coerce``) through
``io.patch_frame`` and every backend with frame bytes identical to the
reference's, ``row_update_from_spans``, ``QuantSpan.from_row_update``,
``EngineConfig.to_dict``/``from_dict`` round trips through the
reference, ``quarantined_count``, ``randomk_compress`` (by its
properties: JAX's PRNG bits cannot be reproduced), ``sparse_add``,
``dense_nbytes``, the meters' ``instruments()``/``reset()``, the cache
logical trees and the package re-exports."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.compression as jcomp
from repro.checkpoint import io as jio
from repro.checkpoint.config import StoreConfig as JaxStoreConfig
from repro.checkpoint.config import TierSpec as JaxTierSpec
from repro.checkpoint.patchset import PatchSet as JaxPatchSet
from repro.checkpoint.patchset import RowUpdate as JaxRowUpdate
from repro.checkpoint.patchset import Span as JaxSpan
from repro.checkpoint.patchset import row_update_from_spans as jax_rufs
from repro.compression.quant_span import QuantSpan as JaxQuantSpan
from repro.compression.sparse import compress_tree as jax_compress_tree
from repro.compression.sparse import dense_nbytes as jax_dense_nbytes
from repro.compression.sparse import sparse_add as jax_sparse_add
from repro.configs import get_config as jax_config
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.models.registry import build_model as jax_model
import repro_torch.checkpoint as ckpt
import repro_torch.compression as comp
from repro_torch import tree_leaves
from repro_torch.checkpoint import io
from repro_torch.checkpoint.config import StoreConfig, StoreConfigError, TierSpec
from repro_torch.checkpoint.patchset import (PatchSet, RowUpdate, Span,
                                             row_update_from_spans)
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.compression.quant_span import QUANT_METER, QuantSpan
from repro_torch.compression.sparse import (compress_tree, dense_nbytes,
                                            randomk_compress, sparse_add)
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core.engine import EngineConfig
from repro_torch.core.snapshot import SnapshotArena
from repro_torch.models.param import abstractify, logical_axes
from repro_torch.models.registry import build_model

torch.set_num_threads(1)


def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal(7).astype(np.float32),
            "w": rng.standard_normal((300, 64)).astype(np.float32),
            "step": 5}


def _port(t):
    return {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
            else v for k, v in t.items()}


def _jax(t):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in t.items()}


def _dicts():
    """The three legacy dict forms, on a1 = w (300, 64) and a0 = b."""
    rng = np.random.default_rng(7)
    rows = [rng.standard_normal((3, 64)).astype(np.float32),
            rng.standard_normal((2, 64)).astype(np.float32)]
    return {
        "arrays": (lambda mk: {"a0": np.full(7, 2.5, np.float32),
                               "a1": rows[0].repeat(100, 0)}),
        "spans": (lambda mk: {"a1": [mk[0](10, rows[0]),
                                     mk[0](290, rows[1])]}),
        "row_update": (lambda mk: {"a1": mk[1](np.array([0, 150], np.int64),
                                               list(rows), (300, 64))}),
    }


PORT_MK = (Span, RowUpdate)
JAX_MK = (JaxSpan, JaxRowUpdate)


@pytest.mark.parametrize("kind", sorted(_dicts()))
def test_coerce_equals_the_reference(kind):
    mk = _dicts()[kind]
    ps, jps = PatchSet.coerce(mk(PORT_MK)), JaxPatchSet.coerce(mk(JAX_MK))
    assert ps.names() == jps.names() and bool(ps) and not PatchSet()
    for n in ps:
        assert ps.shape_of(n) == jps.shape_of(n)
        assert [(s.start, s.data.tobytes()) for s in ps[n]] == \
            [(s.start, np.asarray(s.data).tobytes()) for s in jps[n]]
    assert PatchSet.coerce(ps) is ps
    with pytest.raises(TypeError):
        PatchSet.coerce([1, 2])
    fa = PatchSet.from_arrays({"a0": np.zeros((4, 2))})
    assert fa.is_whole("a0") and fa.shape_of("a0") == (4, 2)


@pytest.mark.parametrize("kind", sorted(_dicts()))
def test_dict_patch_frame_bytes_equal_the_reference(tmp_path, kind):
    mk = _dicts()[kind]
    mine, theirs = str(tmp_path / "mine.ckpt"), str(tmp_path / "theirs.ckpt")
    io.save_frame(mine, _port(_tree()))
    jio.save_frame(theirs, _jax(_tree()))
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    n = io.patch_frame(mine, mk(PORT_MK))
    assert n == jio.patch_frame(theirs, mk(JAX_MK))
    assert open(mine, "rb").read() == open(theirs, "rb").read()


STACKS = {
    "local": lambda tmp: [("local", {})],
    "memory+local": lambda tmp: [("memory", {"capacity_mb": 0.5}),
                                 ("local", {})],
    "sharded": lambda tmp: [("sharded", {"shards": 3})],
    "remote-file": lambda tmp: [("remote", {"url": f"file://{tmp}/bucket",
                                            "chunk_mb": 1 / 256})],
    "peer+local": lambda tmp: [("peer", {"replicas": 2,
                                         "hub": f"hub-{os.path.basename(tmp)}",
                                         "simulate_peers": True}),
                               ("local", {})],
}


def _files(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("kind", sorted(_dicts()))
def test_dict_patch_through_each_backend(tmp_path, stack, kind):
    """The same base blob and the same legacy dict patch through the
    port's and the reference's stack: the bytes each writes are equal
    (remote: the chunks' sha256 and sizes, whose names carry a
    generation id)."""
    mk = _dicts()[kind]
    mine_root, theirs_root = tmp_path / "mine", tmp_path / "theirs"
    spec = STACKS[stack]
    mine = StoreConfig(str(mine_root), tiers=[
        TierSpec(k, **kw) for k, kw in spec(mine_root)]).build_backend()
    theirs = JaxStoreConfig(str(theirs_root), tiers=[
        JaxTierSpec(k, **kw) for k, kw in spec(theirs_root)]).build_backend()
    mine.put("full_00000001", _port(_tree()))
    theirs.put("full_00000001", _jax(_tree()))
    mine.patch("full_00000001", mk(PORT_MK))
    theirs.patch("full_00000001", mk(JAX_MK))
    mine.flush()
    theirs.flush()
    got = mine.get("full_00000001")
    want = theirs.get("full_00000001")
    np.testing.assert_array_equal(np.asarray(got["w"]), np.asarray(want["w"]))
    np.testing.assert_array_equal(np.asarray(got["b"]), np.asarray(want["b"]))
    if stack == "remote-file":
        def shas(root):
            idx = [json.loads(v) for k, v in _files(str(root)).items()
                   if k.endswith("index.json")]
            return sorted((c["sha256"], c["size"]) for i in idx
                          for c in i["chunks"])
        assert shas(mine_root) == shas(theirs_root)
    else:
        a, b = _files(str(mine_root)), _files(str(theirs_root))
        assert sorted(a) == sorted(b)
        for k in a:
            if k.endswith(".json"):
                assert json.loads(a[k]) == json.loads(b[k])
            else:
                assert a[k] == b[k], k
    mine.close()
    theirs.close()


def test_row_update_from_spans_and_quant_span_from_row_update():
    rng = np.random.default_rng(3)
    blocks = [rng.standard_normal((2, 16)).astype(np.float32),
              rng.standard_normal((3, 16)).astype(np.float32)]
    ru = row_update_from_spans([Span(9, blocks[1]), Span(1, blocks[0])],
                               (20, 16))
    jru = jax_rufs([JaxSpan(9, blocks[1]), JaxSpan(1, blocks[0])], (20, 16))
    assert ru.starts.tolist() == jru.starts.tolist() == [1, 9]
    assert ru.shape == jru.shape
    assert [r.tobytes() for r in ru.rows] == [r.tobytes() for r in jru.rows]
    for bits in (8, 4):
        qs = QuantSpan.from_row_update(ru, bits)
        jqs = JaxQuantSpan.from_row_update(jru, bits)
        assert qs.starts == jqs.starts and qs.shape == jqs.shape
        assert qs.dtype == jqs.dtype and qs.bits == jqs.bits
        for a, b in zip(qs.qs + qs.scales, jqs.qs + jqs.scales):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_engine_config_round_trips_through_the_reference():
    cfg = EngineConfig(
        strategy="lowdiff_plus", lr=3e-4, rho=0.02, persist_mode="incremental",
        dirty_granularity="row", diff_quant="int4", maintenance=True,
        device="cpu", store=StoreConfig("/tmp/x", tiers=[
            TierSpec("memory", capacity_mb=64), TierSpec("local")],
            retention_fulls=2))
    d = json.loads(json.dumps(cfg.to_dict()))
    assert "device" not in d
    j = JaxEngineConfig.from_dict(d)
    back = EngineConfig.from_dict(json.loads(json.dumps(j.to_dict())))
    assert back.to_dict() == cfg.to_dict() == j.to_dict()
    assert EngineConfig.from_dict(dict(d, device="cpu")).device == "cpu"
    with pytest.raises(StoreConfigError):
        EngineConfig.from_dict(dict(d, nope=1))
    assert EngineConfig.from_dict({}).to_dict() == \
        JaxEngineConfig.from_dict({}).to_dict()


def test_quarantined_count(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save_full(1, _port(_tree()))
    assert store.quarantined_count == 0
    assert store.quarantine("fulls", "full_00000001", "test")
    assert store.quarantined_count == 1


def test_randomk_by_its_properties():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        3000).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    sg = randomk_compress(x, 0.01, gen)
    nb, k = sg.values.shape
    assert (nb, k) == (3, 11) and sg.indices.dtype == torch.int32
    xb = torch.nn.functional.pad(x, (0, 3 * 1024 - 3000)).reshape(3, 1024)
    for b in range(nb):
        assert len(set(sg.indices[b].tolist())) == k
        assert torch.equal(sg.values[b],
                           xb[b, sg.indices[b].long()] * (1024 / k))
    again = randomk_compress(x, 0.01, torch.Generator().manual_seed(5))
    assert torch.equal(again.indices, sg.indices)
    other = randomk_compress(x, 0.01, torch.Generator().manual_seed(6))
    assert not torch.equal(other.indices, sg.indices)


def test_sparse_add_and_dense_nbytes_equal_the_reference():
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((40, 70)).astype(np.float32)
            for _ in range(2))
    ca = compress_tree({"x": torch.from_numpy(a)}, 0.05)["x"]
    cb = compress_tree({"x": torch.from_numpy(b)}, 0.05)["x"]
    ja = jax_compress_tree({"x": jnp.asarray(a)}, 0.05)["x"]
    jb = jax_compress_tree({"x": jnp.asarray(b)}, 0.05)["x"]
    np.testing.assert_array_equal(sparse_add(ca, cb).numpy(),
                                  np.asarray(jax_sparse_add(ja, jb)))
    tree = {"a": torch.zeros(3, 5), "b": torch.zeros(4, dtype=torch.bfloat16)}
    jtree = {"a": jnp.zeros((3, 5)), "b": jnp.zeros(4, jnp.bfloat16)}
    assert dense_nbytes(tree) == jax_dense_nbytes(jtree) == 68
    c3 = compress_tree({"x": torch.zeros(3, 4)}, 0.05)["x"]
    with pytest.raises(ValueError):
        sparse_add(ca, c3)


def test_meters_instruments_and_reset():
    QUANT_METER.add_encode(0.5, 100, 10)
    assert QUANT_METER.instruments().prefix == "quant"
    QUANT_METER.reset()
    assert QUANT_METER.stats() == {"encode_s": 0.0, "decode_s": 0.0,
                                   "bytes_in": 0, "bytes_out": 0,
                                   "ratio": None}
    io.COPY_METER.add(64)
    io.COPY_METER.add_d2h(32, wait_s=0.1, span_s=0.2)
    assert io.COPY_METER.instruments().prefix == "copy_meter"
    io.COPY_METER.reset()
    assert io.COPY_METER.bytes == 0 and io.COPY_METER.d2h_bytes == 0
    assert io.COPY_METER.d2h_overlap_ratio() is None
    arena = SnapshotArena(slots=1)
    assert arena.instruments().prefix == "snapshot_arena"


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_logical_trees_equal_the_reference(arch):
    model, jmodel = build_model(get_config(arch)), jax_model(jax_config(arch))
    assert model.cache_logical() == jmodel.cache_logical()
    assert model.logical_axes() == jmodel.logical_axes()
    assert logical_axes(model.specs) == jmodel.logical_axes()
    abs_ = abstractify(model.specs, torch.bfloat16)
    assert all(t.device.type == "meta" for t in tree_leaves(abs_))


def test_abstractify_carries_shardings():
    import repro_torch
    model = build_model(get_config("gpt2-l").reduced())
    sh = repro_torch.tree_map(lambda s: ("sh",) + s.shape, model.specs,
                              is_leaf=lambda s: hasattr(s, "logical"))
    got = model.abstract_params(sh)
    assert [t.sharding for t in tree_leaves(got)] == \
        [("sh",) + tuple(t.shape) for t in tree_leaves(got)]


def test_package_exports():
    want = ["BLOCK", "SparseGrad", "compress_tree", "decompress_tree",
            "dense_nbytes", "k_for", "randomk_compress", "sparse_add",
            "topk_compress", "topk_decompress", "tree_nbytes", "QuantGrad",
            "quant_compress", "quant_decompress", "ef_compress_tree",
            "ef_init", "DIFF_QUANTS", "QUANT_METER", "QuantMeter",
            "QuantSpan", "quant_bits"]
    for n in want:
        assert hasattr(jcomp, n) and hasattr(comp, n), n
    for n in ("PatchSet", "RowUpdate", "Span", "mask_to_intervals",
              "merge_span_chain", "row_update_from_spans",
              "make_pspec_splitter"):
        assert hasattr(jckpt, n) and hasattr(ckpt, n), n


def test_memory_tier_patch_leaves_a_running_write_back_alone(tmp_path):
    """A row patch that lands while the blob's own write-back is still
    writing must not splice into the arrays being written (the lower
    tier would keep bytes that differ from their digest): the write-back
    sees the unpatched leaf, and the patch lands after it."""
    import threading
    from repro_torch.checkpoint.backends import (LocalFSBackend,
                                                 MemoryTierBackend)
    entered, release = threading.Event(), threading.Event()

    class Gated(LocalFSBackend):
        def put(self, key, obj):
            self.seen = obj
            entered.set()
            assert release.wait(timeout=30)
            return super().put(key, obj)

    lower = Gated(str(tmp_path))
    tier = MemoryTierBackend(lower, capacity_bytes=1 << 20)
    tree = _tree()
    tier.put("full_00000001", _port(tree))
    assert entered.wait(timeout=30)
    rows = np.full((5, 64), 9.0, np.float32)
    tier.patch("full_00000001", {"a1": [Span(40, rows)]})
    seen_w = np.array(np.asarray(lower.seen["w"]))
    release.set()
    tier.flush()
    np.testing.assert_array_equal(seen_w, tree["w"])
    want = tree["w"].copy()
    want[40:45] = 9.0
    for be in (tier, lower):
        np.testing.assert_array_equal(np.asarray(be.get("full_00000001")["w"]),
                                      want)
    assert lower.verify("full_00000001") is None
    tier.close()
