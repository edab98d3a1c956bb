"""The port's frame codec and chain store against the JAX reference's:
the same state gives byte-identical frames, each package loads the
other's frames, and a chain written by either package recovers in the
other (reduced gpt2-l, on the CPU)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.checkpoint import io as jio
from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.compression.sparse import SparseGrad as JaxSparse
from repro.configs import get_config as jax_config
from repro.core import recovery as jrec
from repro.core.lowdiff import LowDiff as JaxLowDiff
from repro.core.steps import init_state as jax_init_state
from repro.data.synthetic import make_batch as jax_batch
from repro.models.registry import build_model as jax_model
from repro.optim.adam import AdamState as JaxAdam
from repro_torch import tree_leaves
from repro_torch.checkpoint import io
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.compression.sparse import SparseGrad
from repro_torch.configs import get_config
from repro_torch.core import recovery as rec
from repro_torch.core.lowdiff import LowDiff
from repro_torch.core.steps import init_state
from repro_torch.data.synthetic import make_batch
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamState


def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"w": f(3, 1100), "b": f(7), "h": f(4, 8)}
    return {
        "ef": {k: v * 0.1 for k, v in params.items()},
        "opt": (params, {k: v * v for k, v in params.items()}, 3),
        "params": params,
        "step": 5,
        "wire": (f(4, 11), rng.integers(0, 1024, (4, 11)).astype(np.int32),
                 (3, 1100)),
    }


def _jax_obj(s):
    j = jax.tree.map(jnp.asarray, s["params"])
    return {
        "ef": jax.tree.map(jnp.asarray, s["ef"]),
        "opt": JaxAdam(j, jax.tree.map(jnp.asarray, s["opt"][1]),
                       jnp.asarray(s["opt"][2], jnp.int32)),
        "params": dict(j, bf=jnp.asarray(s["params"]["h"], jnp.bfloat16)),
        "step": jnp.asarray(s["step"], jnp.int32),
        "batch": {"mode": "concat", "first": 5, "last": 5, "payloads": [
            {"w": JaxSparse(jnp.asarray(s["wire"][0]),
                            jnp.asarray(s["wire"][1]), s["wire"][2])}]},
    }


def _torch_obj(s):
    t = jax.tree.map(torch.from_numpy, s["params"])
    return {
        "ef": jax.tree.map(torch.from_numpy, s["ef"]),
        "opt": AdamState(t, jax.tree.map(torch.from_numpy, s["opt"][1]),
                         torch.tensor(s["opt"][2], dtype=torch.int32)),
        "params": dict(t, bf=torch.from_numpy(s["params"]["h"]).to(
            torch.bfloat16)),
        "step": torch.tensor(s["step"], dtype=torch.int32),
        "batch": {"mode": "concat", "first": 5, "last": 5, "payloads": [
            {"w": SparseGrad(torch.from_numpy(s["wire"][0]),
                             torch.from_numpy(s["wire"][1]), s["wire"][2])}]},
    }


def test_frames_are_byte_identical():
    s = _numpy_state()
    assert io.frame_dumps(_torch_obj(s)) == jio.frame_dumps(_jax_obj(s))


def test_each_package_loads_the_others_frames():
    s = _numpy_state(1)
    mine = io.frame_loads(jio.frame_dumps(_jax_obj(s)), verify=True)
    theirs = jio.frame_loads(io.frame_dumps(_torch_obj(s)), verify=True)
    assert isinstance(mine["opt"], AdamState)
    assert isinstance(theirs["opt"], JaxAdam)
    sg, jsg = mine["batch"]["payloads"][0]["w"], \
        theirs["batch"]["payloads"][0]["w"]
    assert isinstance(sg, SparseGrad) and isinstance(jsg, JaxSparse)
    assert sg.shape == jsg.shape == (3, 1100)
    np.testing.assert_array_equal(np.asarray(sg.indices), s["wire"][1])
    np.testing.assert_array_equal(np.asarray(jsg.indices), s["wire"][1])
    assert mine["params"]["bf"].dtype == torch.bfloat16
    assert theirs["params"]["bf"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        mine["params"]["bf"].float().numpy(),
        np.asarray(theirs["params"]["bf"], np.float32))
    for k in ("w", "b", "h"):
        np.testing.assert_array_equal(mine["params"][k], s["params"][k])
        np.testing.assert_array_equal(theirs["params"][k], s["params"][k])
    assert int(mine["step"]) == int(theirs["step"]) == 5


def _assert_state_close(params, opt, ref_params, ref_opt):
    # the packages round 1-b**count (f32 pow) and the moment sums (XLA
    # fma vs separate roundings) an ulp apart per replayed step; over a
    # few steps that stays far below these bounds
    for a, b in zip(tree_leaves(params), jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-6)
    for a, b in zip(tree_leaves((opt.mu, opt.nu)),
                    jax.tree.leaves((ref_opt.mu, ref_opt.nu))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-9)
    assert int(opt.count) == int(ref_opt.count)


def test_port_chain_recovers_in_reference(tmp_path):
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    strat = LowDiff(model, CheckpointStore(str(tmp_path)), full_interval=4,
                    batch_size=2, device="cpu")
    state = init_state(model, 3, device="cpu")
    for t in range(7):
        state, _ = strat.train_step(state, make_batch(cfg, 64, 2, step=t))
    strat.close()
    jstate, diffs = jrec.load_latest_chain(JaxStore(str(tmp_path)))
    diffs = jrec.contiguous_prefix(int(jstate["step"]), diffs)
    assert [s for s, _ in diffs] == [5, 6, 7]
    jp, jopt = jrec.replay_serial(jstate["params"], jstate["opt"], diffs)
    _assert_state_close(state["params"], state["opt"], jp, jopt)


def test_reference_chain_recovers_in_port(tmp_path):
    jcfg = jax_config("gpt2-l").reduced()
    jm = jax_model(jcfg)
    jstrat = JaxLowDiff(jm, JaxStore(str(tmp_path)), full_interval=4,
                        batch_size=2, parallel_recovery=False)
    jstate = jax_init_state(jm, jax.random.PRNGKey(4))
    for t in range(7):
        jstate, _ = jstrat.train_step(jstate, jax_batch(jcfg, 64, 2, step=t))
    jstrat.close()
    state, diffs = rec.load_latest_chain(CheckpointStore(str(tmp_path)))
    diffs = rec.contiguous_prefix(int(state["step"]), diffs)
    assert [s for s, _ in diffs] == [5, 6, 7]
    params, opt = rec.replay_serial(state["params"], state["opt"], diffs,
                                    device="cpu")
    _assert_state_close(params, opt, jstate["params"], jstate["opt"])
