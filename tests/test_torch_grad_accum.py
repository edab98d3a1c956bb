"""Gradient accumulation and the other dense configs in the port, against
the JAX reference on the CPU: ``_grads`` with ``grad_accum`` 2 (f32
accumulator) and 4 (bf16 accumulator), one whole lowdiff step of each
new config (reduced, its own ``grad_accum`` restored), and the config
registry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import _REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_config
from repro.core.steps import _grads as jax_grads
from repro.core.steps import init_state as jax_init_state
from repro.core.steps import make_train_step as jax_make_step
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.configs import _REGISTRY, get_config
from repro_torch.configs.base import DTYPES
from repro_torch.core.steps import _grads, _micro, init_state, make_train_step
from repro_torch.data.synthetic import make_batch
from repro_torch.models.param import from_jax_params
from repro_torch.models.registry import build_model

NEW_ARCHS = ("stablelm-1.6b", "granite-3-8b", "llama3-405b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module, as in ``test_torch_packed``:
    under the suite's parallel workers torch's thread pools
    oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pair(arch, **kw):
    """(reference model, port model) of the reduced ``arch`` with ``kw``
    set on both configs."""
    return (jax_model(jax_config(arch).reduced().replace(**kw)),
            build_model(get_config(arch).reduced().replace(**kw)))


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.mark.parametrize("accum,acc_dtype", [(2, "float32"),
                                             (4, "bfloat16")])
def test_grads_accumulate_like_reference(accum, acc_dtype):
    """Same params and batch of 4 rows. Both packages return the
    accumulated gradient in the accumulator's dtype, the mean loss and
    the reference's metrics. Tolerance per dtype: with an f32 buffer,
    each leaf within 1e-4 of its largest magnitude, the tolerance of one
    f32 gradient (``test_torch_data_model``), since the micro-batch
    gradients agree to that and are summed and halved alike. With a bf16
    buffer a rounding difference of the f32 gradients can tip the
    rounding of a cast or a partial sum: each leaf also within one bf16
    ulp (2^-8) of its largest magnitude per micro-batch, and at least
    99.9% of the elements bitwise equal."""
    jm, m = _pair("gpt2-l", grad_accum=accum, grad_accum_dtype=acc_dtype)
    jp = jm.init(jax.random.PRNGKey(1))
    batch = make_batch(m.cfg, 64, 4, step=1)
    jloss, jmet, jg = jax_grads(jm, jp, _jbatch(batch), accum)
    params = from_jax_params(jax.tree.map(np.asarray, jp), m.specs)
    loss, met, g = _grads(m, params, batch, accum)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
    assert sorted(met) == sorted(jmet) == ["aux", "tokens", "xent"]
    assert float(met["xent"]) == float(loss)
    assert float(met["aux"]) == float(met["tokens"]) == 0.0
    assert loss.dtype == torch.float32
    same = total = 0
    for x, y in zip(tree_leaves(g), jax.tree.leaves(jg)):
        assert x.dtype == DTYPES[acc_dtype]
        assert np.asarray(y).dtype == np.dtype(jnp.dtype(acc_dtype))
        xf, yf = x.float().numpy(), np.asarray(y, np.float32)
        scale = float(np.abs(yf).max()) + 1e-12
        tol = 1e-4 * scale
        if acc_dtype == "bfloat16":
            tol += accum * 2.0 ** -8 * scale
        np.testing.assert_allclose(xf, yf, rtol=0, atol=tol)
        same += int((xf == yf).sum())
        total += xf.size
    if acc_dtype == "bfloat16":
        assert same >= 0.999 * total, (same, total)


def test_micro_batches_are_contiguous_and_summed_in_order():
    """``accum`` 2 in f32 equals, bit for bit, the mean of two one-batch
    gradients of rows [0, 2) and [2, 4): micro-batches are contiguous
    (never strided), added in order into a zeroed buffer, then halved."""
    m = build_model(get_config("gpt2-l").reduced().replace(grad_accum=2))
    params = m.init(5, device="cpu")
    batch = make_batch(m.cfg, 32, 4, step=2)
    first = _micro(batch, 2, 0)
    assert torch.equal(first["tokens"], batch["tokens"][:2])
    assert torch.equal(_micro(batch, 2, 1)["targets"],
                       batch["targets"][2:])
    loss, _, g = _grads(m, params, batch, 2)
    halves = [_grads(m, params, {k: v[i:i + 2] for k, v in batch.items()},
                     1) for i in (0, 2)]
    assert float(loss) == float((halves[0][0] + halves[1][0]) / 2)
    for a, h0, h1 in zip(tree_leaves(g), tree_leaves(halves[0][2]),
                         tree_leaves(halves[1][2])):
        want = (torch.zeros_like(h0) + h0 + h1) / 2
        assert torch.equal(a.view(torch.int32), want.view(torch.int32))


def _corrected(ef, cg):
    """The EF-corrected gradients a lowdiff step compressed, rebuilt from
    its outputs: the new residual is ``corrected - decompress(cg)``, zero
    at the picks, so adding the picks back gives ``corrected`` (by value;
    a -0.0 may come back as +0.0)."""
    out = []
    for e, (vals, idx) in zip(ef, zip(cg[0::2], cg[1::2])):
        flat = np.zeros(vals.shape[0] * 1024, np.float32)
        flat[:e.size] = e.reshape(-1)
        rows = flat.reshape(vals.shape[0], 1024)
        np.put_along_axis(rows, idx, np.take_along_axis(rows, idx, 1)
                          + vals, 1)
        out.append(rows)
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_whole_lowdiff_step_matches_reference(arch):
    """One lowdiff step (top-k + error feedback) from the same params and
    batch, on the reduced config with its own ``grad_accum`` (and, for
    llama3, its bf16 accumulator) restored. ``test_torch_step``'s
    tolerances: loss within 2e-6 relative, params within 2e-5 on the
    blocks whose top-k rows agree, and those rows equal in >= 99.9% of
    blocks (measured: 2306 of 2307 blocks for stablelm and granite, 2305
    of 2307 for llama3). Every block whose corrected gradient is the
    same in both packages picks the same rows. With the bf16 accumulator
    the corrected gradients are bitwise the same in over half the blocks
    (measured 1310 of 2307 for llama3), so that rule is asserted on at
    least half of them; with f32 few are (17 of 2307), as the two
    packages sum in different orders."""
    full = get_config(arch)
    jm, m = _pair(arch, grad_accum=full.grad_accum)
    assert m.cfg.grad_accum_dtype == full.grad_accum_dtype
    jstate = jax_init_state(jm, jax.random.PRNGKey(2), mode="lowdiff")
    batch = make_batch(m.cfg, 64, 4, step=3)
    jnew, jmet, jcg = jax_make_step(jm, mode="lowdiff")(jstate,
                                                        _jbatch(batch))
    params = from_jax_params(jax.tree.map(np.asarray, jstate["params"]),
                             m.specs)
    state = init_state(m, mode="lowdiff", device="cpu", params=params)
    new, met, cg = make_train_step(m, mode="lowdiff")(state, batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=2e-6)
    assert int(new["step"]) == int(jnew["step"]) == 1
    mine = [l.numpy() for l in tree_leaves(cg)]
    ref = [np.asarray(l) for l in jax.tree.leaves(jcg)]
    same_grad = [(a == b).all(axis=1) for a, b in zip(
        _corrected([e.numpy() for e in tree_leaves(new["ef"])], mine),
        _corrected([np.asarray(e) for e in jax.tree.leaves(jnew["ef"])],
                   ref))]
    if m.cfg.grad_accum_dtype == "bfloat16":
        nsame = sum(int(x.sum()) for x in same_grad)
        assert nsame >= 0.5 * sum(x.size for x in same_grad), nsame
    agree = total = 0
    for (a, b), s, j, same in zip(
            zip(tree_leaves(new["params"]), jax.tree.leaves(jnew["params"])),
            mine[1::2], ref[1::2], same_grad):
        rows = (s == j).all(axis=1)
        assert rows[same].all()
        agree += int(rows.sum())
        total += rows.size
        mask = np.repeat(rows, 1024)[:a.numel()]
        np.testing.assert_allclose(a.numpy().reshape(-1)[mask],
                                   np.asarray(b).reshape(-1)[mask],
                                   rtol=0, atol=2e-5)
    assert agree >= 0.999 * total, (agree, total)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_are_the_reference_dataclasses(arch):
    import dataclasses
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))


def test_registry_lists_the_reference_dense_archs():
    dense = {a for a in JAX_REGISTRY
             if jax_config(a).arch_type == "dense"}
    assert set(_REGISTRY) == dense
