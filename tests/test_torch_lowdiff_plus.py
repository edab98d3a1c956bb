"""The port's LowDiff+ against the JAX reference's, on the CPU: the numpy
replica (dirty tracking, RowUpdate / QuantSpan snapshots with error
feedback, remark on a failed persist) is identical; patch chains are
byte-identical on disk and load, fold and cross-load bitwise in both
packages; the device overlay (K7's plain version here) equals the host
overlay; and LowDiffPlus runs end to end on reduced gpt2-l, from the
training CLI too."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.configs import get_config as jax_config
from repro.core.lowdiff_plus import LowDiffPlus as JaxLowDiffPlus
from repro.core.lowdiff_plus import _NumpyAdam as JaxNumpyAdam
from repro.core.steps import init_state as jax_init_state
from repro.data.synthetic import make_batch as jax_batch
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.checkpoint import io
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.core import recovery as rec
from repro_torch.core.lowdiff_plus import (LowDiffPlus, _flatten, _NumpyAdam,
                                           _unflatten_like)
from repro_torch.core.steps import init_state
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import build
from repro_torch.models.param import from_jax_params
from repro_torch.models.registry import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {"['a']": (6, 5), "['b']['c']": (4, 2, 3), "['b']['d']": (5,),
          "['e']": (1, 4), "['f']": ()}


def _grads(steps, seed=0):
    """Per-step gradients with zero rows (row tracking has work) and a
    leaf that stays zero for its first steps (the skip proof)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        g = {}
        for k, s in SHAPES.items():
            a = rng.standard_normal(s).astype(np.float32)
            if a.ndim and a.shape[0] > 2:
                a[rng.random(a.shape[0]) < 0.4] = 0.0
            if k == "['e']" and t < 2:
                a[:] = 0.0
            g[k] = a
        out.append(g)
    return out


def _start(seed=1):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    zeros = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    return params, zeros


def _replica(cls, **kw):
    params, zeros = _start()
    return cls({k: v.copy() for k, v in params.items()},
               {k: v.copy() for k, v in zeros.items()},
               {k: v.copy() for k, v in zeros.items()}, 0, lr=0.05,
               track_dirty=True, **kw)


def _internal(r):
    return {"params": r.params, "mu": r.mu, "nu": r.nu, "count": r.count,
            "dirty": sorted(r._dirty), "drift": r._drift,
            "row_dirty": r._row_dirty, "row_drift": r._row_drift,
            "resid": {"/".join(k): v for k, v in r._row_resid.items()},
            "qpending": r._row_qpending, "skipped": r.skipped_applies}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))
    else:
        assert a == b


REPLICAS = [("leaf", "off", 0.0), ("leaf", "off", 0.3),
            ("row", "off", 0.0), ("row", "off", 0.3),
            ("row", "int8", 0.0), ("row", "int8", 0.3),
            ("row", "int4", 0.0), ("row", "int4", 0.3)]


@pytest.mark.parametrize("gran,quant,threshold", REPLICAS)
def test_replica_matches_reference(gran, quant, threshold):
    """Same gradients through both replicas: state, every snapshot's
    frame bytes (RowUpdate / QuantSpan payloads), deferred counts and
    the effect of remark_dirty are identical."""
    mine = _replica(_NumpyAdam, dirty_granularity=gran, diff_quant=quant)
    ref = _replica(JaxNumpyAdam, dirty_granularity=gran, diff_quant=quant)
    for t, g in enumerate(_grads(7)):
        mine.apply({k: v.copy() for k, v in g.items()})
        ref.apply({k: v.copy() for k, v in g.items()})
        if t == 0:
            snaps = mine.snapshot_full(), ref.snapshot_full()
            assert io.frame_dumps(snaps[0]) == jio.frame_dumps(snaps[1])
            continue
        (u, d), (ju, jd) = (mine.snapshot_dirty(threshold),
                            ref.snapshot_dirty(threshold))
        assert d == jd
        assert io.frame_dumps(u) == jio.frame_dumps(ju)
        if t == 3:                        # this persist "failed"
            mine.remark_dirty(u)
            ref.remark_dirty(ju)
        _assert_same(_internal(mine), _internal(ref))


def _keystrs(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_flat_keys_are_the_references_keystr_paths():
    jcfg = jax_config("gpt2-l").reduced()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    model = build_model(get_config("gpt2-l").reduced())
    params = model.init(0, device="cpu")
    flat = _flatten(params)
    assert list(flat) == _keystrs(jparams)
    assert "['layers']['ffn']['wd']" in flat
    back = _unflatten_like(params, flat)
    assert all(a is b for a, b in zip(tree_leaves(back),
                                      tree_leaves(params)))


# ---------------------------------------------------------------- chains
MIXED = {2: "off", 3: "int8", 4: "int4", 5: "int4"}
RAW_AFTER_QUANT = {2: "int4", 3: "off", 4: "int8", 5: "off"}


def _write_chain(pkg, root, codecs=MIXED):
    """full at step 1, then patches in ``codecs``' widths (default: raw
    RowUpdates, int8, int4, int4)."""
    cls, store = ((_NumpyAdam, CheckpointStore(root)) if pkg == "port"
                  else (JaxNumpyAdam, JaxStore(root)))
    r = _replica(cls, dirty_granularity="row", diff_quant="int8")
    for t, g in enumerate(_grads(5, seed=3), 1):
        r.apply(g)
        if t == 1:
            store.save_full(t, r.snapshot_full(), record_names=True)
            continue
        r.diff_quant = codecs[t]
        u, _ = r.snapshot_dirty()
        store.save_patch(t, "full_00000001", u)
    return store, r


def _assert_state_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_state_bitwise(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                          y.reshape(-1).view(np.uint8))


def _no_path(entry):
    return {k: v for k, v in entry.items() if k != "path"}


def test_chains_are_byte_identical_and_cross_load(tmp_path):
    mine, mr = _write_chain("port", str(tmp_path / "port"))
    ref, _ = _write_chain("jax", str(tmp_path / "jax"))
    for kind in ("fulls", "patches"):
        assert [_no_path(e) for e in mine.manifest[kind]] == \
            [_no_path(e) for e in ref.manifest[kind]]
    for f in sorted(os.listdir(tmp_path / "port")):
        if f.endswith(".ckpt"):
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes(), f
    assert any("int4" in e.get("codec", []) for e in mine.manifest["patches"])
    state, step = mine.load_latest_state()
    assert step == 5
    for other in (JaxStore(str(tmp_path / "port")),
                  CheckpointStore(str(tmp_path / "jax")), ref):
        got, s = other.load_latest_state()
        assert s == step
        _assert_state_bitwise(state, got)
    # within a quantization step of the replica that wrote it
    for k, v in mr.params.items():
        np.testing.assert_allclose(state["params"][k], v, rtol=0, atol=0.6)
    assert mine.chain_amplification() == ref.chain_amplification() > 0


def test_fold_leaves_latest_state_bitwise_unchanged(tmp_path):
    mine, _ = _write_chain("port", str(tmp_path / "port"))
    ref, _ = _write_chain("jax", str(tmp_path / "jax"))
    before, step = mine.load_latest_state()
    assert mine.fold_sync(merge_slice=2) == 4
    assert ref.fold_sync(merge_slice=2) == 4
    assert not mine.manifest["patches"] and mine.folds == 1
    after, s = mine.load_latest_state()
    assert s == step == 5
    _assert_state_bitwise(before, after)
    got, s = JaxStore(str(tmp_path / "port")).load_latest_state()
    _assert_state_bitwise(before, got)
    assert (tmp_path / "port" / "full_00000001.ckpt").read_bytes() == \
        (tmp_path / "jax" / "full_00000001.ckpt").read_bytes()
    assert mine.chain_amplification() == ref.chain_amplification() == 0.0
    assert [_no_path(e) for e in mine.manifest["fulls"]] == \
        [_no_path(e) for e in ref.manifest["fulls"]]


@pytest.mark.parametrize("cut,codecs", [
    pytest.param(None, MIXED, id="None"),
    pytest.param("patch_00000004", MIXED, id="patch_00000004"),
    pytest.param(None, RAW_AFTER_QUANT, id="raw-after-quantized")])
def test_device_overlay_equals_host_overlay(tmp_path, cut, codecs):
    """``load_state_device`` (K7's plain version on the CPU) gives the
    host overlay's bytes, and cuts the chain at a missing patch as the
    host path does; a raw patch may follow a quantized one on a leaf."""
    store, _ = _write_chain("port", str(tmp_path), codecs)
    jstore = JaxStore(str(tmp_path))
    if cut:          # lost after the manifest was read: a gap mid-chain
        os.unlink(tmp_path / f"{cut}.ckpt")
    host, step = store.load_latest_state()
    build.reset_launches()
    dev, dstep = rec.load_state_device(store, device="cpu")
    assert dstep == step == (3 if cut else 5)
    _assert_state_bitwise(host, dev)
    assert all(v == 0 for v in build.LAUNCHES.values())
    ref, rstep = jstore.load_latest_state()
    assert rstep == step
    _assert_state_bitwise(ref, dev)
    # blob by blob, overlay_device is merge_updates' twin
    state = store.load_full(store.manifest["fulls"][0])
    for pe in store.patch_chain("full_00000001")[:(2 if cut else 4)]:
        rec.overlay_device(state, store.backend.get(pe["key"])["updates"],
                           device="cpu")
    _assert_state_bitwise(host, state)


def test_device_overlay_owns_only_the_live_device_leaves(tmp_path):
    """After each blob the overlay's owned map holds exactly the state's
    device leaves: a leaf that a raw patch replaced is dropped, so its id
    can never be mistaken for a later leaf's."""
    store, _ = _write_chain("port", str(tmp_path), RAW_AFTER_QUANT)
    state = store.load_full(store.manifest["fulls"][0])
    owned = {}
    for pe in store.patch_chain("full_00000001"):
        rec._overlay(state, store.backend.get(pe["key"])["updates"],
                     torch.device("cpu"), owned)
        live = {id(v) for v in tree_leaves(state)
                if isinstance(v, torch.Tensor)}
        assert set(owned) == live
    assert not owned            # the last patch is raw


# ------------------------------------------------------------ end to end
def _run_port(root, jparams, steps):
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    params = from_jax_params(jparams, model.specs)
    state = init_state(model, mode="lowdiff_plus", device="cpu",
                       params=params)
    strat = LowDiffPlus(model, CheckpointStore(root), persist_interval=1,
                        persist_mode="incremental", dirty_granularity="row",
                        diff_quant="int4", fold_interval=2, queue_size=2,
                        device="cpu")
    for t in range(steps):
        state, _ = strat.train_step(state, make_batch(cfg, 64, 2, step=t))
    strat.flush()
    return strat, state


def _run_reference(root, steps):
    jcfg = jax_config("gpt2-l").reduced()
    jm = jax_model(jcfg)
    jstate = jax_init_state(jm, jax.random.PRNGKey(5), mode="lowdiff_plus")
    jparams = jax.tree.map(np.asarray, jstate["params"])
    strat = JaxLowDiffPlus(jm, JaxStore(root), persist_interval=1,
                           persist_mode="incremental",
                           dirty_granularity="row", diff_quant="int4",
                           fold_interval=2, queue_size=2)
    for t in range(steps):
        jstate, _ = strat.train_step(jstate, jax_batch(jcfg, 64, 2, step=t))
    strat.flush()
    return strat, jparams


def _bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_lowdiff_plus_end_to_end_matches_reference(tmp_path):
    steps = 4
    jstrat, jparams = _run_reference(str(tmp_path / "jax"), steps)
    strat, state = _run_port(str(tmp_path / "port"), jparams, steps)
    try:
        store = strat.store
        assert store.folds == 1 and strat.patch_persists == 3
        # the written keys are the reference's keystr strings
        assert [_no_path(e)["names"] for e in store.manifest["fulls"]] == \
            [_no_path(e)["names"] for e in jstrat.store.manifest["fulls"]]
        assert [sorted(e["extents"]) for e in store.manifest["patches"]] \
            == [sorted(e["extents"]) for e in
                jstrat.store.manifest["patches"]]
        # software recovery returns the replica, bit for bit
        soft = strat.recover_software(state)
        rep = strat._replica
        assert int(soft["step"]) == steps and int(soft["opt"].count) == steps
        flat = {"params": _flatten(soft["params"]),
                "mu": _flatten(soft["opt"].mu),
                "nu": _flatten(soft["opt"].nu)}
        for comp in ("params", "mu", "nu"):
            for k, v in getattr(rep, comp).items():
                assert _bitwise(flat[comp][k], torch.from_numpy(v)), (comp, k)
        # hardware recovery equals the device overlay
        hard = strat.recover_hardware(state)
        dev, step = rec.load_state_device(store, device="cpu")
        assert int(hard["step"]) == step == steps
        hflat = {"params": _flatten(hard["params"]),
                 "mu": _flatten(hard["opt"].mu),
                 "nu": _flatten(hard["opt"].nu)}
        for comp in ("params", "mu", "nu"):
            for k, v in dev[comp].items():
                assert _bitwise(hflat[comp][k], torch.from_numpy(v)), (comp, k)
        # the two replicas saw gradients that round differently (the
        # packages sum in other orders); after a few Adam steps from the
        # same start each weight stays within a few lr of the reference's
        # and nearly all of them far closer
        jrep = jstrat._replica
        for k, v in rep.params.items():
            d = np.abs(v - jrep.params[k])
            assert d.max() <= 4 * 1e-3, k
            assert (d > 1e-5).mean() <= 1e-3, k
        # the moments average those gradients: their rounding differences
        # scale with the leaf's largest moment, not with each element
        # (3.3e-4 of it for mu and 1.2e-4 for nu measured; bound 2e-3)
        for comp in ("mu", "nu"):
            for k, v in getattr(rep, comp).items():
                w = getattr(jrep, comp)[k]
                assert np.abs(v - w).max() <= 2e-3 * np.abs(w).max(), k
    finally:
        strat.close()
        jstrat.close()


def test_recover_software_is_a_copy(tmp_path):
    """The recovered tensors do not alias the replica: later applies do
    not change them."""
    _, jparams = _run_reference(str(tmp_path / "jax"), 1)
    strat, state = _run_port(str(tmp_path / "port"), jparams, 1)
    soft = strat.recover_software(state)
    before = [t.clone() for t in tree_leaves(soft["params"])]
    cfg = get_config("gpt2-l").reduced()
    state, _ = strat.train_step(soft, make_batch(cfg, 64, 2, step=1))
    strat.flush()
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(soft["params"])))
    strat.close()


def test_train_cli_lowdiff_plus_recovers(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "gpt2-l", "--reduced", "--strategy", "lowdiff_plus",
         "--persist-mode", "incremental", "--dirty-granularity", "row",
         "--diff-quant", "int4", "--steps", "8", "--fail-at", "6",
         "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "recovered at step 6; resuming" in out.stdout
    assert "8 steps in" in out.stdout


def test_lowdiff_plus_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(get_config("gpt2-l").reduced())
    with pytest.raises(RuntimeError, match="is_available"):
        LowDiffPlus(model, CheckpointStore(str(tmp_path)))
    with pytest.raises(RuntimeError, match="is_available"):
        rec.load_state_device(CheckpointStore(str(tmp_path)))


def test_lowdiff_plus_rejects_quant_without_incremental_rows(tmp_path):
    model = build_model(get_config("gpt2-l").reduced())
    for kw in ({"persist_mode": "full", "dirty_granularity": "row"},
               {"persist_mode": "incremental"}):
        with pytest.raises(ValueError, match="diff-quant"):
            LowDiffPlus(model, CheckpointStore(str(tmp_path)),
                        diff_quant="int8", device="cpu", **kw)
