"""Port parity: configs, synthetic batches, and the dense LM's loss and
gradients against the JAX reference (reduced sizes, f32, on the CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.synthetic import make_batch as jax_batch
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.configs import get_config
from repro_torch.data.synthetic import TokenStream, make_batch
from repro_torch.models.param import from_jax_params, init_std
from repro_torch.models.registry import build_model

ARCHS = ["gpt2-l", "qwen2-1.5b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal(arch, reduced):
    a, b = get_config(arch), jax_config(arch)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert str(a.pdtype()).split(".")[-1] == str(b.pdtype())
    assert str(a.cdtype()).split(".")[-1] == str(b.cdtype())


def test_gpt2_l_full_width_count():
    # the slice's main path: 36L d1280 SwiGLU -> 1,072,469,760 params
    cfg = get_config("gpt2-l")
    assert cfg.param_count() == 1_072_469_760
    assert build_model(cfg).n_params() == jax_model(
        jax_config("gpt2-l")).n_params()


@pytest.mark.parametrize("step,seed", [(0, 0), (5, 3)])
def test_batches_equal(step, seed):
    cfg = get_config("gpt2-l").reduced()
    mine = make_batch(cfg, 64, 3, step=step, seed=seed)
    ref = jax_batch(jax_config("gpt2-l").reduced(), 64, 3, step=step,
                    seed=seed)
    for k in ("tokens", "targets"):
        assert mine[k].dtype == torch.int32
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))
    ts = TokenStream(cfg, 64, 3, seed=seed)
    ts.step = step
    np.testing.assert_array_equal(next(ts)["tokens"].numpy(),
                                  mine["tokens"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_module(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    ref = jax_model(jax_config(arch).reduced())
    shapes = jax.tree.map(lambda s: tuple(s.shape), ref.abstract_params())
    ref_names = sorted(jax.tree_util.keystr(p, simple=True, separator=".")
                       for p, _ in jax.tree_util.tree_leaves_with_path(
                           shapes, is_leaf=lambda x: isinstance(x, tuple)))
    names = sorted(n for n, _ in model.named_parameters())
    assert names == ref_names
    assert isinstance(model, torch.nn.Module)
    params = model.init(0, device="cpu")
    assert [tuple(p.shape) for p in tree_leaves(params)] == \
        jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple))
    # fan-in rule: stacked layer dim excluded
    wq = params["layers"]["attn"]["wq"]
    spec = model.specs["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) / init_std(spec) - 1) < 0.05


def _jax_loss_grads(arch, batch_np):
    cfg = jax_config(arch).reduced()
    model = jax_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    (loss, _), grads = jax.value_and_grad(model.loss_fn, has_aux=True)(
        params, batch)
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg = get_config(arch).reduced()
    batch = make_batch(cfg, 64, 2, step=1)
    params_np, loss_ref, grads_ref = _jax_loss_grads(
        arch, {k: v.numpy() for k, v in batch.items()})
    model = build_model(cfg)
    params = from_jax_params(params_np, model.specs)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    # f32 throughout; the two frameworks sum in different orders, so
    # loss agrees to ~1e-6 relative and each gradient leaf to 1e-4 of
    # its own scale
    np.testing.assert_allclose(float(loss.detach()), loss_ref, rtol=2e-6)
    for g, r in zip(grads, jax.tree.leaves(grads_ref)):
        scale = float(np.abs(r).max()) + 1e-12
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * scale)
    # the module's own forward (parameters bound in) is the same function
    model.load_params(from_jax_params(params_np))
    with torch.no_grad():
        assert float(model(batch)[0]) == float(loss.detach())
