"""The packed compressor of the port (K8 ``pack_select``, K9
``pack_scatter``, K10 ``packed_apply``; their plain versions here, which
``chip_smoke.py`` holds the CUDA kernels to on the card) against the JAX
reference, on the CPU and on the same numpy inputs:

* wire data is bitwise equal to the jitted reference — K8's q, indices
  and scale bits against ``ops.packed_compress`` (the Pallas kernel in
  interpret mode) and its jitted jnp oracle — on inputs where a true
  division by 127 would give other scales; K9's decode is bitwise equal
  to ``ops.packed_decompress``;
* K10 agrees with ``ops.fused_packed_apply`` within ``assert_adam_close``
  (XLA contracts the moment update into an fma; the port rounds each
  product);
* a packed step agrees with ``repro.core.steps.make_train_step``;
* frames are byte-identical, chains written by either package recover in
  the other, the port's serial and device replays are bitwise equal and
  parallel replay agrees within its reassociation tolerance, and a
  corrupt payload cuts the chain;
* the training CLI recovers with ``--compressor packed``.

The helpers at the top are shared with ``test_torch_quant8.py``."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.compression.packed import PackedDiff as JaxPacked
from repro.compression.quant import QuantGrad as JaxQuant
from repro.configs import get_config as jax_config
from repro.core import recovery as jrec
from repro.core.lowdiff import LowDiff as JaxLowDiff
from repro.core.steps import init_state as jax_init_state
from repro.core.steps import make_train_step as jax_make_step
from repro.data.synthetic import make_batch as jax_batch
from repro.kernels import ops as jops
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.checkpoint import io
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.compression.packed import PackedDiff
from repro_torch.compression.quant import QuantGrad
from repro_torch.compression.sparse import is_compressed, tree_nbytes
from repro_torch.configs import get_config
from repro_torch.core import recovery as rec
from repro_torch.core.lowdiff import LowDiff
from repro_torch.core.steps import init_state, make_train_step
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import build, ops, pack, ref, replay
from repro_torch.models.param import from_jax_params
from repro_torch.models.registry import build_model
from test_torch_checkpoint import _assert_state_close
from test_torch_kernels import _hyper, _state, assert_adam_close
from test_torch_lowdiff import _assert_replay_close, _bits, _env

STEPS = 7           # full at step 4, differentials 5, 6, 7 (f = 4, b = 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: under the suite's parallel
    workers, torch's thread pools oversubscribe the CPU and the many
    small ops of a chain replay wait on each other. The ops are the
    same, so are the results."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def rounding_input():
    """(999, 3001) f32, normal * 0.37 from seed 0: 2,928 blocks, some of
    whose absmax / 127 rounds differently as a true division than as the
    reciprocal multiply the jitted reference computes."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((999, 3001)) * 0.37).astype(np.float32)


def true_division_scales(amax: np.ndarray) -> np.ndarray:
    """max(amax / 127, 1e-12) as an IEEE f32 division (what the eager,
    un-jitted reference expression computes)."""
    return np.maximum(amax.astype(np.float32) / np.float32(127.0),
                      np.float32(1e-12))


def f32_bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# -------------------- reduced gpt2-l chains, both packages --------------

def _jax_start(seed: int = 4):
    jcfg = jax_config("gpt2-l").reduced()
    jm = jax_model(jcfg)
    return jcfg, jm, jax_init_state(jm, jax.random.PRNGKey(seed))


def train_chains(root, compressor: str) -> dict:
    """Port and reference LowDiff runs of reduced gpt2-l from the same
    params (carried with ``from_jax_params``) and batches, each writing
    its chain (f = 4, b = 2: a full at step 4, differentials 5-7) under
    ``root``. Returns the two directories and trained states."""
    jcfg, jm, jstate = _jax_start()
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jstate["params"]),
                             model.specs)
    port_dir, ref_dir = os.path.join(root, "port"), os.path.join(root, "ref")
    strat = LowDiff(model, CheckpointStore(port_dir), full_interval=4,
                    batch_size=2, compressor=compressor, device="cpu")
    state = init_state(model, device="cpu", params=params)
    for t in range(STEPS):
        state, _ = strat.train_step(state, make_batch(cfg, 64, 2, step=t))
    strat.close()
    jstrat = JaxLowDiff(jm, JaxStore(ref_dir), full_interval=4, batch_size=2,
                        compressor=compressor, parallel_recovery=False)
    for t in range(STEPS):
        jstate, _ = jstrat.train_step(jstate, jax_batch(jcfg, 64, 2, step=t))
    jstrat.close()
    return {"port_dir": port_dir, "port": state, "ref_dir": ref_dir,
            "ref": jstate}


def port_chain(path):
    state, diffs = rec.load_latest_chain(CheckpointStore(path))
    return state, rec.contiguous_prefix(int(state["step"]), diffs)


def check_port_chain_recovers_in_reference(chains):
    jstate, diffs = jrec.load_latest_chain(JaxStore(chains["port_dir"]))
    diffs = jrec.contiguous_prefix(int(jstate["step"]), diffs)
    assert [s for s, _ in diffs] == [5, 6, 7]
    jp, jopt = jrec.replay_serial(jstate["params"], jstate["opt"], diffs)
    _assert_state_close(chains["port"]["params"], chains["port"]["opt"], jp,
                        jopt)


def check_reference_chain_recovers_in_port(chains):
    state, diffs = port_chain(chains["ref_dir"])
    assert [s for s, _ in diffs] == [5, 6, 7]
    jtrained = chains["ref"]
    params, opt = rec.replay_serial(state["params"], state["opt"], diffs,
                                    device="cpu")
    _assert_state_close(params, opt, jtrained["params"], jtrained["opt"])
    pp, popt, n = rec.replay_parallel(state["params"], state["opt"], diffs,
                                      device="cpu")
    assert n == 3
    _assert_state_close(pp, popt, jtrained["params"], jtrained["opt"])


def check_port_replays(chains, monkeypatch):
    """Serial and device replay of the port's own chain equal the trained
    state bit for bit; parallel replay (whole leaves, and chunks of 64
    blocks, so that leaves split into several chunks and a ragged last
    one) agrees within the reassociation tolerance, the chunks bitwise
    equal to the whole."""
    state, diffs = port_chain(chains["port_dir"])
    trained = tree_leaves((chains["port"]["params"], chains["port"]["opt"]))
    sp, sopt = rec.replay_serial(state["params"], state["opt"], diffs,
                                 device="cpu")
    for window in (None, 2):
        dp, dopt, n = rec.replay_device(state["params"], state["opt"], diffs,
                                        window=window, device="cpu")
        assert n == 3
        for a, b, c in zip(tree_leaves((dp, dopt)), tree_leaves((sp, sopt)),
                           trained):
            assert torch.equal(_bits(a), _bits(b))
            assert torch.equal(_bits(a), _bits(c))
    whole = rec.replay_parallel(state["params"], state["opt"], diffs,
                                device="cpu")
    assert whole[2] == 3
    _assert_replay_close(tree_leaves(whole[:2]), trained)
    monkeypatch.setattr(rec, "SCRATCH_BYTES", 32 * 3 * 64 * 1024)
    assert rec._chunk_elems(3, 1024) == 64 * 1024
    chunked = rec.replay_parallel(state["params"], state["opt"], diffs,
                                  device="cpu")
    for a, b in zip(tree_leaves(whole[:2]), tree_leaves(chunked[:2])):
        assert torch.equal(_bits(a), _bits(b))


def check_corrupt_payload_cuts_the_chain(chains, corrupt):
    """A payload that ``corrupt(leaf)`` spoils cuts the chain before it
    in device and parallel replay; spoiled first, the full's state comes
    back untouched."""
    state, diffs = port_chain(chains["port_dir"])
    key = sorted(diffs[1][1])[0]

    def spoil(i):
        bad = dict(diffs[i][1])
        bad[key] = corrupt(bad[key])
        return diffs[:i] + [(diffs[i][0], bad)] + diffs[i + 1:]
    with pytest.raises(ValueError, match="corrupt differential"):
        rec._check_wire(spoil(1)[1][1])
    start = int(state["opt"].count)
    for replay in (rec.replay_device, rec.replay_parallel):
        _, opt, n = replay(state["params"], state["opt"], spoil(1),
                           device="cpu")
        assert n == 1 and int(opt.count) == start + 1
        params, opt, n = replay(state["params"], state["opt"], spoil(0),
                                device="cpu")
        assert n == 0 and int(opt.count) == start
        for a, b in zip(tree_leaves(params), tree_leaves(state["params"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def check_train_cli_recovers(tmp_path, compressor: str, replay_device: str):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "gpt2-l", "--reduced", "--compressor", compressor,
         "--steps", "8", "--full-interval", "4", "--fail-at", "7",
         "--replay-device", replay_device, "--ckpt-dir",
         str(tmp_path / "ck"), "--log-every", "4"],
        capture_output=True, text=True, env=dict(_env(), OMP_NUM_THREADS="1"),
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "recovered at step 7; resuming" in out.stdout
    assert "8 steps in" in out.stdout


# ------------------------------------------------------------- K8 / K9

def _blocks(kind: str) -> np.ndarray:
    if kind == "rounding":
        return rounding_input()
    rng = np.random.default_rng(5)
    if kind == "ties":          # few distinct magnitudes: exact ties
        return rng.integers(-3, 4, 4 * 1024 + 300).astype(np.float32)
    x = rng.standard_normal(3 * 1024 + 7).astype(np.float32)
    x[1024:2048] = 0.0          # an all-zero block: scale 1e-12, q 0
    return x


@pytest.mark.parametrize("kind", ["rounding", "ties", "zeros"])
@pytest.mark.parametrize("k", [1, 11, 103])
def test_pack_select_matches_jitted_reference(kind, k):
    """K8's plain version gives the Pallas kernel's (and the jitted
    oracle's) q, indices and scale bits exactly."""
    x = _blocks(kind)
    rho = k / 1024
    pd = ops.packed_compress(torch.from_numpy(x), rho)
    nb = -(-x.size // 1024)
    assert pd.q.shape == pd.indices.shape == (nb, k)
    assert pd.scale.shape == (nb, 1) and pd.q.dtype == torch.int8
    for use_pallas in (True, False):
        jpd = jops.packed_compress(jnp.asarray(x), rho,
                                   use_pallas=use_pallas)
        np.testing.assert_array_equal(pd.q.numpy(), np.asarray(jpd.q))
        np.testing.assert_array_equal(pd.indices.numpy(),
                                      np.asarray(jpd.indices))
        np.testing.assert_array_equal(f32_bits(pd.scale), f32_bits(jpd.scale))
    # K8 selects as K1 does
    sg = ops.topk_compress(torch.from_numpy(x), rho)
    assert torch.equal(pd.indices, sg.indices)
    if kind == "zeros":
        assert float(pd.scale[1, 0]) == np.float32(1e-12)
        assert not pd.q[1].any()
    if kind == "rounding":
        # the scale is the reciprocal multiply: a true division differs
        amax = np.abs(sg.values[:, :1].numpy())
        true = true_division_scales(amax)
        assert (f32_bits(true) != f32_bits(pd.scale)).any()
        assert (f32_bits(amax * np.float32(1.0 / 127.0))
                == f32_bits(pd.scale)).all()


@pytest.mark.parametrize("kind", ["rounding", "ties", "zeros"])
def test_pack_scatter_matches_reference(kind):
    x = _blocks(kind)
    jpd = jops.packed_compress(jnp.asarray(x), 0.01)
    pd = PackedDiff(*(torch.from_numpy(np.array(a))
                      for a in (jpd.q, jpd.indices, jpd.scale)), x.shape)
    dense = ops.packed_decompress(pd)
    assert dense.shape == x.shape and dense.dtype == torch.float32
    np.testing.assert_array_equal(f32_bits(dense),
                                  f32_bits(jops.packed_decompress(jpd)))
    np.testing.assert_array_equal(f32_bits(pd.dense()),
                                  f32_bits(jpd.dense()))


@pytest.mark.parametrize("n,k", [(2500, 11), (4096, 1), (4096, 103),
                                 (2500, 0)])
def test_packed_apply_matches_pallas(n, k):
    p, g, mu, nu = _state(n, seed=3)
    nb = -(-n // 1024)
    if k:
        q, idx, scale = ref.pack_select_ref(ref.to_blocks(
            torch.from_numpy(g), 1024)[0], k)
        q, idx, scale = q.numpy(), idx.numpy(), scale.numpy()
    else:                       # hand-built empty payload (k_for never 0)
        q = np.zeros((nb, 0), np.int8)
        idx = np.zeros((nb, 0), np.int32)
        scale = np.full((nb, 1), 1e-12, np.float32)
    mine_h, jax_h = _hyper(5)
    out = ops.fused_packed_apply(
        PackedDiff(*map(torch.from_numpy, (q, idx, scale)), (n,)),
        *map(torch.from_numpy, (p, mu, nu)), mine_h)
    jpd = JaxPacked(*map(jnp.asarray, (q, idx, scale)), (n,))
    jout = jops.fused_packed_apply(jpd, *map(jnp.asarray, (p, mu, nu)),
                                   jax_h, use_pallas=True)
    dense = np.asarray(jops.packed_decompress(jpd)) if k else \
        np.zeros(n, np.float32)
    assert_adam_close([t.numpy() for t in out], jout, p, dense, mu, nu,
                      mine_h.numpy())
    # K10 is K4 on the dequantized values, bit for bit
    vals = torch.from_numpy(q).float() * torch.from_numpy(scale)
    k4 = replay.topk_apply(vals, torch.from_numpy(idx),
                           *map(torch.from_numpy, (p, mu, nu)), mine_h)
    for a, b in zip(out, k4):
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_versions():
    build.reset_launches()
    x = torch.from_numpy(_blocks("zeros"))
    q, i, s = pack.pack_select(x, 11)
    rq, ri, rs = ref.pack_select_ref(ref.to_blocks(x, 1024)[0], 11)
    assert torch.equal(q, rq) and torch.equal(i, ri) and torch.equal(s, rs)
    d = pack.pack_scatter(q, i, s, x.numel())
    assert torch.equal(d, ref.pack_scatter_ref(q, i, s, 1024).reshape(-1)[
        :x.numel()])
    p, _, mu, nu = map(torch.from_numpy, _state(x.numel()))
    h, _ = _hyper(2)
    blocks = [ref.to_blocks(t, 1024)[0] for t in (p, mu, nu)]
    out = replay.packed_apply(q, i, s, p, mu, nu, h)
    for a, b in zip(out, ref.packed_apply_ref(q, i, s, *blocks, h,
                                              block=1024)):
        assert torch.equal(a, ref.unblock(b, p.shape))
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert {"pack_select", "pack_scatter", "packed_apply"} <= set(
        build.LAUNCHES)


# ---------------------------------------------------- containers, codec

def _payload(seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (3, 11)).astype(np.int8)
    idx = np.stack([rng.choice(1024, 11, replace=False)
                    for _ in range(3)]).astype(np.int32)
    scale = rng.random((3, 1)).astype(np.float32)
    return q, idx, scale, (2, 1100)


def _batch(payload):
    return {"mode": "concat", "first": 5, "last": 5,
            "payloads": [{"w": payload}]}


def test_packed_frames_are_byte_identical_and_cross_load():
    q, idx, scale, shape = _payload()
    mine = PackedDiff(*map(torch.from_numpy, (q, idx, scale)), shape)
    theirs = JaxPacked(*map(jnp.asarray, (q, idx, scale)), shape)
    assert mine.nbytes == theirs.nbytes == 3 * 11 * (1 + 2) + 3 * 4
    assert tree_nbytes({"w": mine, "b": mine}) == 2 * mine.nbytes
    assert is_compressed(mine) and not is_compressed(q)
    data = io.frame_dumps(_batch(mine))
    assert data == jio.frame_dumps(_batch(theirs))
    _, arrays = io.pack(mine)
    assert arrays[1].dtype == np.int16      # indices on the wire
    back = io.frame_loads(jio.frame_dumps(_batch(theirs)), verify=True)
    got = back["payloads"][0]["w"]
    assert isinstance(got, PackedDiff) and got.shape == shape
    assert np.asarray(got.indices).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(got.indices), idx)
    np.testing.assert_array_equal(np.asarray(got.q), q)
    np.testing.assert_array_equal(np.asarray(got.scale), scale)
    jback = jio.frame_loads(data, verify=True)["payloads"][0]["w"]
    assert isinstance(jback, JaxPacked)
    assert np.asarray(jback.indices).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(jback.indices), idx)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    return train_chains(str(tmp_path_factory.mktemp("packed")), "packed")


def test_packed_step_same_gradient():
    """Same gradient, residual, params and moments: the port's K8 -> K9
    -> K10 step gives the reference's wire data and residual exactly,
    and its state within ``assert_adam_close``."""
    from repro.compression.error_feedback import \
        ef_compress_tree_with as jax_ef
    from repro.optim.adam import AdamState as JaxAdam
    from repro.optim.adam import adam_update as jax_adam
    from repro_torch.compression.error_feedback import ef_compress_tree_with
    from repro_torch.core.steps import _apply_tree
    from repro_torch.optim.adam import AdamState
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 700), "b": (2048,), "c": (5,)}
    tree = lambda s=1.0: {k: (rng.standard_normal(v) * s).astype(  # noqa: E731
        np.float32) for k, v in shapes.items()}
    grads, ef, params, mu = tree(), tree(0.1), tree(), tree(0.1)
    nu = {k: np.abs(v) * 0.01 for k, v in tree().items()}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    cg, ef2 = ef_compress_tree_with(t(grads), t(ef),
                                    lambda g: ops.packed_compress(g, 0.01),
                                    ops.packed_decompress)
    jcg, jef2 = jax_ef(j(grads), j(ef), lambda g: jops.packed_compress(
        g, 0.01), jops.packed_decompress)
    for s, r in zip(tree_leaves(cg), jax.tree.leaves(jcg)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(r))
    for s, r in zip(tree_leaves(ef2), jax.tree.leaves(jef2)):
        np.testing.assert_array_equal(f32_bits(s), f32_bits(r))
    opt = AdamState(t(mu), t(nu), torch.tensor(3, dtype=torch.int32))
    hyper = ops.adam_hyper_traced(1e-3, 0.9, 0.999, 1e-8, opt.count + 1)
    p2, opt2 = _apply_tree(t(params), cg, opt, hyper, opt.count + 1)
    jg = jax.tree.map(jops.packed_decompress, jcg,
                      is_leaf=lambda x: isinstance(x, JaxPacked))
    jp2, jopt2 = jax_adam(j(params), jg, JaxAdam(j(mu), j(nu), jnp.asarray(
        3, jnp.int32)), lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    for i, k in enumerate(sorted(shapes)):
        assert_adam_close(
            [p2[k].numpy(), opt2.mu[k].numpy(), opt2.nu[k].numpy()],
            [jp2[k], jopt2.mu[k], jopt2.nu[k]], params[k],
            np.asarray(jg[k]), mu[k], nu[k], hyper.numpy())
    assert int(opt2.count) == int(jopt2.count) == 4


def test_whole_packed_step_matches_reference():
    """One packed step from the same params and batch. The two gradients
    round differently, so a near-tie may flip a pick and a scale may
    round an ulp apart: index rows must agree in >= 99.9% of blocks; on
    those, scales agree within 1e-5 relative, codes within one step
    (>= 99.9% exactly) and the params within 2e-5."""
    jcfg, jm, jstate = _jax_start(2)
    cfg = get_config("gpt2-l").reduced()
    batch = make_batch(cfg, 64, 2, step=3)
    jnew, jmet, jcg = jax_make_step(jm, compressor="packed")(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    model = build_model(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jstate["params"]),
                             model.specs)
    state = init_state(model, device="cpu", params=params)
    new, met, cg = make_train_step(model, compressor="packed")(state, batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=2e-6)
    assert sorted(new) == sorted(jnew) == ["ef", "opt", "params", "step"]
    mine = tree_leaves(cg, is_leaf=is_compressed)
    theirs = jax.tree.leaves(jcg, is_leaf=lambda x: isinstance(x, JaxPacked))
    agree = total = same_q = 0
    for a, b, s, r in zip(tree_leaves(new["params"]),
                          jax.tree.leaves(jnew["params"]), mine, theirs):
        assert isinstance(s, PackedDiff) and isinstance(r, JaxPacked)
        rows = (s.indices.numpy() == np.asarray(r.indices)).all(axis=1)
        np.testing.assert_allclose(s.scale.numpy()[rows],
                                   np.asarray(r.scale)[rows], rtol=1e-5)
        dq = np.abs(s.q.numpy()[rows].astype(np.int32)
                    - np.asarray(r.q)[rows])
        assert dq.max(initial=0) <= 1
        same_q += int((dq == 0).sum())
        agree += int(rows.sum())
        total += rows.size
        mask = np.repeat(rows, 1024)[:a.numel()]
        np.testing.assert_allclose(a.numpy().reshape(-1)[mask],
                                   np.asarray(b).reshape(-1)[mask],
                                   rtol=0, atol=2e-5)
    assert agree >= 0.999 * total, (agree, total)
    assert same_q >= 0.999 * agree * mine[0].q.shape[1], same_q


def test_port_chain_recovers_in_reference(chains):
    check_port_chain_recovers_in_reference(chains)


def test_reference_chain_recovers_in_port(chains):
    check_reference_chain_recovers_in_port(chains)


def test_port_replays_agree(chains, monkeypatch):
    state, diffs = port_chain(chains["port_dir"])
    assert all(isinstance(l, PackedDiff) for _, d in diffs
               for l in tree_leaves(d, is_leaf=is_compressed))
    check_port_replays(chains, monkeypatch)


@pytest.mark.parametrize("corrupt", ["rows", "q_scale", "indices"])
def test_corrupt_packed_payload_cuts_the_chain(chains, corrupt):
    spoil = {
        "rows": lambda pd: PackedDiff(pd.q[:-1], pd.indices[:-1],
                                      pd.scale[:-1], pd.shape, pd.block),
        "q_scale": lambda pd: PackedDiff(pd.q, pd.indices, pd.scale[:-1],
                                         pd.shape, pd.block),
        "indices": lambda pd: PackedDiff(pd.q, pd.indices[:, :-1],
                                         pd.scale, pd.shape, pd.block),
    }[corrupt]
    check_corrupt_payload_cuts_the_chain(chains, spoil)


@pytest.mark.parametrize("replay_device", ["on", "off"])
def test_train_cli_packed_recovers(tmp_path, replay_device):
    check_train_cli_recovers(tmp_path, "packed", replay_device)


def test_quant_and_packed_containers_are_tree_nodes():
    """Both containers walk as tree nodes (their arrays are the leaves,
    so host copies and uploads keep the container) and count their wire
    bytes as the reference does."""
    q = torch.zeros((2, 1024), dtype=torch.int8)
    qg = QuantGrad(q, torch.ones(2), (2000,))
    assert tree_leaves(qg)[0] is q and len(tree_leaves(qg)) == 2
    assert qg.nbytes == JaxQuant(jnp.zeros((2, 1024), jnp.int8),
                                 jnp.ones(2), (2000,)).nbytes == 2056
    moved = rec.to_device({"w": qg}, "cpu")["w"]
    assert isinstance(moved, QuantGrad) and moved.shape == (2000,)
    assert rec._payload_nbytes({"w": qg}) == 2 * 1024 + 2 * 4
