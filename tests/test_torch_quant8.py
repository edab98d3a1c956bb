"""The quant8 compressor of the port (K11 ``quantize``, K12
``dequantize``, K13 ``quant_apply``; their plain versions here, which
``chip_smoke.py`` holds the CUDA kernels to on the card) against the JAX
reference, on the CPU and on the same numpy inputs:

* K11's q and scale bits equal ``jax.jit(quant_compress)`` — the form the
  reference's step computes, where XLA turns ``/ 127.0`` into a multiply
  by ``f32(1/127)`` — and the Pallas ``ops.quant_compress`` in interpret
  mode, on an input where a true division (the eager expression) gives
  other scales; K12 decodes bit for bit as ``quant_decompress``;
* K13 agrees with ``ops.fused_quant_apply`` within ``assert_adam_close``;
* a quant8 step agrees with ``repro.core.steps.make_train_step``, and its
  state has no error feedback in either package;
* frames are byte-identical (scale (nb,)), chains written by either
  package recover in the other, the port's serial and device replays are
  bitwise equal and parallel replay agrees within its reassociation
  tolerance, a corrupt payload cuts the chain, and the training CLI
  recovers with ``--compressor quant8``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.compression import quant as jquant
from repro.compression.quant import QuantGrad as JaxQuant
from repro.core.lowdiff import LowDiff as JaxLowDiff
from repro.kernels import ops as jops
from repro.kernels import quant8 as jq8
from repro_torch import tree_leaves
from repro_torch.checkpoint import io
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.compression.quant import QuantGrad
from repro_torch.compression.sparse import is_compressed, tree_nbytes
from repro_torch.configs import get_config
from repro_torch.core.lowdiff import LowDiff
from repro_torch.core.steps import init_state, make_train_step
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import build, ops, quant8, ref, replay
from repro_torch.models.param import from_jax_params
from repro_torch.models.registry import build_model
from test_torch_kernels import _hyper, _state, assert_adam_close
from test_torch_packed import (  # noqa: F401 (one_torch_thread: autouse)
    _jax_start, check_corrupt_payload_cuts_the_chain,
    check_port_chain_recovers_in_reference, check_port_replays,
    check_reference_chain_recovers_in_port, check_train_cli_recovers,
    f32_bits, rounding_input, one_torch_thread, port_chain, train_chains,
    true_division_scales)

JIT_QUANT = jax.jit(jquant.quant_compress)


def _input(kind: str) -> np.ndarray:
    if kind == "rounding":
        return rounding_input()
    rng = np.random.default_rng(6)
    x = rng.standard_normal(3 * 1024 + 7).astype(np.float32)
    if kind == "zeros":
        x[1024:2048] = 0.0      # an all-zero block: scale 1e-12, q 0
    else:                       # absmax 127, so x / scale lands on or next
        # to the half steps j + 1/2: the rounding mode decides the codes
        x[:1024] = (np.arange(1024) % 254 - 126.5).astype(np.float32)
        x[0] = 127.0
    return x


def test_scale_is_the_jitted_reciprocal_multiply():
    """The plain versions of K11 and K8 give the jitted reference's scale
    and q bits; on this input a true division by 127 (the eager
    reference) gives other scales in some blocks, so the test tells the
    two roundings apart."""
    x = rounding_input()
    xb = ref.to_blocks(torch.from_numpy(x), 1024)[0]
    q, scale = ref.quantize_ref(xb)
    jg = JIT_QUANT(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jg.q))
    np.testing.assert_array_equal(f32_bits(scale[:, 0]), f32_bits(jg.scale))
    amax = xb.abs().amax(dim=1).numpy()
    differ = f32_bits(true_division_scales(amax)) != f32_bits(scale[:, 0])
    assert differ.any() and not differ.all()
    eager = jquant.quant_compress(jnp.asarray(x))
    assert (f32_bits(eager.scale) != f32_bits(jg.scale)).any()
    pq, pi, ps = ref.pack_select_ref(xb, 11)
    jpd = jops.packed_compress(jnp.asarray(x), 11 / 1024)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jpd.q))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpd.indices))
    np.testing.assert_array_equal(f32_bits(ps), f32_bits(jpd.scale))


@pytest.mark.parametrize("kind", ["rounding", "zeros", "half_steps"])
def test_quantize_matches_jitted_reference(kind):
    x = _input(kind)
    qg = ops.quant_compress(torch.from_numpy(x))
    nb = -(-x.size // 1024)
    assert qg.q.shape == (nb, 1024) and qg.q.dtype == torch.int8
    assert qg.scale.shape == (nb,) and qg.shape == x.shape
    jg = JIT_QUANT(jnp.asarray(x))
    np.testing.assert_array_equal(qg.q.numpy(), np.asarray(jg.q))
    np.testing.assert_array_equal(f32_bits(qg.scale), f32_bits(jg.scale))
    for use_pallas in (True, False):
        pq, ps = jops.quant_compress(jnp.asarray(x), use_pallas=use_pallas)
        np.testing.assert_array_equal(qg.q.numpy(), np.asarray(pq))
        np.testing.assert_array_equal(f32_bits(qg.scale),
                                      f32_bits(np.asarray(ps)[:, 0]))
    if kind == "zeros":
        assert float(qg.scale[1]) == np.float32(1e-12) and not qg.q[1].any()
    tail = x.size % 1024
    if tail:                    # the padded tail quantizes to 0
        assert not qg.q[-1, tail:].any()


@pytest.mark.parametrize("kind", ["rounding", "zeros"])
def test_dequantize_matches_reference(kind):
    x = _input(kind)
    jg = JIT_QUANT(jnp.asarray(x))
    qg = QuantGrad(torch.from_numpy(np.array(jg.q)),
                   torch.from_numpy(np.array(jg.scale)), x.shape)
    dense = ops.quant_decompress(qg)
    assert dense.shape == x.shape and dense.dtype == torch.float32
    np.testing.assert_array_equal(f32_bits(dense),
                                  f32_bits(jquant.quant_decompress(jg)))
    np.testing.assert_array_equal(f32_bits(qg.dense()), f32_bits(jg.dense()))
    nb = jg.q.shape[0]                  # the Pallas kernel, 8-row tiles
    rpad = -nb % jq8.ROWS
    pallas = jq8.dequantize(jnp.pad(jg.q, ((0, rpad), (0, 0))),
                            jnp.pad(jg.scale[:, None], ((0, rpad), (0, 0))),
                            interpret=True)
    np.testing.assert_array_equal(
        f32_bits(dense).reshape(-1),
        f32_bits(np.asarray(pallas)[:nb]).reshape(-1)[:x.size])


@pytest.mark.parametrize("n", [2500, 4096])
def test_quant_apply_matches_pallas(n):
    p, g, mu, nu = _state(n, seed=4)
    q, scale = quant8.quantize(torch.from_numpy(g))
    mine_h, jax_h = _hyper(5)
    out = ops.fused_quant_apply(QuantGrad(q, scale, (n,)),
                                *map(torch.from_numpy, (p, mu, nu)), mine_h)
    jqg = JaxQuant(jnp.asarray(q.numpy()), jnp.asarray(scale.numpy()), (n,))
    jout = jops.fused_quant_apply(jqg, *map(jnp.asarray, (p, mu, nu)),
                                  jax_h, use_pallas=True)
    dense = np.asarray(jquant.quant_decompress(jqg))
    assert_adam_close([t.numpy() for t in out], jout, p, dense, mu, nu,
                      mine_h.numpy())


def test_cpu_tensors_take_the_plain_versions():
    build.reset_launches()
    x = torch.from_numpy(_input("zeros"))
    q, s = quant8.quantize(x)
    rq, rs = ref.quantize_ref(ref.to_blocks(x, 1024)[0])
    assert torch.equal(q, rq) and torch.equal(s, rs.reshape(-1))
    d = quant8.dequantize(q, s, x.numel())
    assert torch.equal(d, ref.dequantize_ref(q, s).reshape(-1)[:x.numel()])
    p, _, mu, nu = map(torch.from_numpy, _state(x.numel()))
    h, _ = _hyper(2)
    blocks = [ref.to_blocks(t, 1024)[0] for t in (p, mu, nu)]
    out = replay.quant_apply(q, s, p, mu, nu, h)
    for a, b in zip(out, ref.quant_apply_ref(q, s, *blocks, h)):
        assert torch.equal(a, ref.unblock(b, p.shape))
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert {"quantize", "dequantize", "quant_apply"} <= set(build.LAUNCHES)


def test_quant_frames_are_byte_identical_and_cross_load():
    rng = np.random.default_rng(2)
    q = rng.integers(-127, 128, (2, 1024)).astype(np.int8)
    scale = rng.random(2).astype(np.float32)
    mine = QuantGrad(torch.from_numpy(q), torch.from_numpy(scale), (1900,))
    theirs = JaxQuant(jnp.asarray(q), jnp.asarray(scale), (1900,))
    assert tree_nbytes({"w": mine}) == mine.nbytes == theirs.nbytes == 2056
    batch = lambda w: {"mode": "concat", "first": 5,  # noqa: E731
                       "last": 5, "payloads": [{"w": w}]}
    data = io.frame_dumps(batch(mine))
    assert data == jio.frame_dumps(batch(theirs))
    got = io.frame_loads(jio.frame_dumps(batch(theirs)),
                         verify=True)["payloads"][0]["w"]
    assert isinstance(got, QuantGrad) and got.shape == (1900,)
    assert np.asarray(got.scale).shape == (2,)
    np.testing.assert_array_equal(np.asarray(got.q), q)
    jgot = jio.frame_loads(data, verify=True)["payloads"][0]["w"]
    assert isinstance(jgot, JaxQuant)
    np.testing.assert_array_equal(np.asarray(jgot.scale), scale)


def test_quant8_step_same_gradient():
    """Same gradient, params and moments: the port's K11 -> K13 step
    gives the jitted reference's codes and scales exactly and its state
    within ``assert_adam_close``."""
    from repro.optim.adam import AdamState as JaxAdam
    from repro.optim.adam import adam_update as jax_adam
    from repro_torch.core.steps import _apply_tree
    from repro_torch.optim.adam import AdamState
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 700), "b": (2048,), "c": (5,)}
    tree = lambda s=1.0: {k: (rng.standard_normal(v) * s).astype(  # noqa: E731
        np.float32) for k, v in shapes.items()}
    grads, params, mu = tree(), tree(), tree(0.1)
    nu = {k: np.abs(v) * 0.01 for k, v in tree().items()}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    cg = {k: ops.quant_compress(v) for k, v in t(grads).items()}
    jcg = {k: JIT_QUANT(v) for k, v in j(grads).items()}
    for k in shapes:
        np.testing.assert_array_equal(cg[k].q.numpy(), np.asarray(jcg[k].q))
        np.testing.assert_array_equal(f32_bits(cg[k].scale),
                                      f32_bits(jcg[k].scale))
    opt = AdamState(t(mu), t(nu), torch.tensor(3, dtype=torch.int32))
    hyper = ops.adam_hyper_traced(1e-3, 0.9, 0.999, 1e-8, opt.count + 1)
    p2, opt2 = _apply_tree(t(params), cg, opt, hyper, opt.count + 1)
    jg = {k: jquant.quant_decompress(v) for k, v in jcg.items()}
    jp2, jopt2 = jax_adam(j(params), jg, JaxAdam(j(mu), j(nu), jnp.asarray(
        3, jnp.int32)), lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    for k in shapes:
        assert_adam_close(
            [p2[k].numpy(), opt2.mu[k].numpy(), opt2.nu[k].numpy()],
            [jp2[k], jopt2.mu[k], jopt2.nu[k]], params[k],
            np.asarray(jg[k]), mu[k], nu[k], hyper.numpy())


def test_whole_quant8_step_matches_reference_and_drops_ef():
    """One quant8 step from the same params and batch: neither package
    keeps error feedback. The two gradients round differently, so a
    code may land one step apart: >= 99.9% of codes agree exactly, the
    scales within 1e-5 relative, and where the codes agree the params
    agree within 2e-5."""
    from repro.core.steps import make_train_step as jax_make_step
    jcfg, jm, jstate = _jax_start(2)
    assert "ef" in jstate           # both init_states make it; the step
    cfg = get_config("gpt2-l").reduced()      # drops it
    batch = make_batch(cfg, 64, 2, step=3)
    jnew, jmet, jcg = jax_make_step(jm, compressor="quant8")(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    model = build_model(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jstate["params"]),
                             model.specs)
    state = init_state(model, device="cpu", params=params)
    assert "ef" in state
    new, met, cg = make_train_step(model, compressor="quant8")(state, batch)
    assert sorted(new) == sorted(jnew) == ["opt", "params", "step"]
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=2e-6)
    mine = tree_leaves(cg, is_leaf=is_compressed)
    theirs = jax.tree.leaves(jcg, is_leaf=lambda x: isinstance(x, JaxQuant))
    same = total = 0
    for a, b, s, r in zip(tree_leaves(new["params"]),
                          jax.tree.leaves(jnew["params"]), mine, theirs):
        assert isinstance(s, QuantGrad) and isinstance(r, JaxQuant)
        np.testing.assert_allclose(s.scale.numpy(), np.asarray(r.scale),
                                   rtol=1e-5)
        dq = np.abs(s.q.numpy().astype(np.int32) - np.asarray(r.q))
        assert dq.max() <= 1
        same += int((dq == 0).sum())
        total += dq.size
        mask = (dq == 0).reshape(-1)[:a.numel()]
        np.testing.assert_allclose(a.numpy().reshape(-1)[mask],
                                   np.asarray(b).reshape(-1)[mask],
                                   rtol=0, atol=2e-5)
    assert same >= 0.999 * total, (same, total)


def test_lowdiff_quant8_runs_without_error_feedback(tmp_path):
    """Both packages' LowDiff turn error feedback off for quant8: the
    trained and the recovered states carry no ``"ef"``."""
    jcfg, jm, jstate = _jax_start()
    jstrat = JaxLowDiff(jm, None, compressor="quant8")
    jnew, _, _ = jstrat.step_fn(jstate, {
        k: jnp.asarray(v.numpy()) for k, v in make_batch(
            get_config("gpt2-l").reduced(), 64, 2, step=0).items()})
    assert "ef" not in jnew
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    strat = LowDiff(model, CheckpointStore(str(tmp_path)), full_interval=2,
                    batch_size=1, compressor="quant8", device="cpu")
    state = init_state(model, 0, device="cpu")
    for t in range(3):
        state, _ = strat.train_step(state, make_batch(cfg, 64, 2, step=t))
        assert "ef" not in state
    strat.flush()
    recovered, applied = strat.recover()
    strat.close()
    assert applied == 1 and sorted(recovered) == ["opt", "params", "step"]


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    return train_chains(str(tmp_path_factory.mktemp("quant8")), "quant8")


def test_port_chain_recovers_in_reference(chains):
    check_port_chain_recovers_in_reference(chains)


def test_reference_chain_recovers_in_port(chains):
    check_reference_chain_recovers_in_port(chains)


def test_port_replays_agree(chains, monkeypatch):
    _, diffs = port_chain(chains["port_dir"])
    assert all(isinstance(l, QuantGrad) for _, d in diffs
               for l in tree_leaves(d, is_leaf=is_compressed))
    check_port_replays(chains, monkeypatch)


@pytest.mark.parametrize("corrupt", ["rows", "q_scale", "block"])
def test_corrupt_quant_payload_cuts_the_chain(chains, corrupt):
    spoil = {
        "rows": lambda qg: QuantGrad(qg.q[:-1], qg.scale[:-1], qg.shape,
                                     qg.block),
        "q_scale": lambda qg: QuantGrad(qg.q, qg.scale[:-1], qg.shape,
                                        qg.block),
        "block": lambda qg: QuantGrad(qg.q[:, :-1], qg.scale, qg.shape,
                                      qg.block),
    }[corrupt]
    check_corrupt_payload_cuts_the_chain(chains, spoil)


@pytest.mark.parametrize("replay_device", ["on", "off"])
def test_train_cli_quant8_recovers(tmp_path, replay_device):
    check_train_cli_recovers(tmp_path, "quant8", replay_device)
