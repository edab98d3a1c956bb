"""The port's training step against the JAX reference's, on the CPU:
compress -> error feedback -> update from the same gradient, a whole
step from the same params and batch, and the fused K4 update against
the port's own plain ``adam_update``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression.error_feedback import ef_compress_tree as jax_ef
from repro.compression.sparse import decompress_tree as jax_decompress
from repro.configs import get_config as jax_config
from repro.core.steps import init_state as jax_init_state
from repro.core.steps import make_train_step as jax_make_step
from repro.models.registry import build_model as jax_model
from repro.optim.adam import AdamState as JaxAdam
from repro.optim.adam import adam_update as jax_adam
from repro_torch import tree_leaves
from repro_torch.compression.error_feedback import ef_compress_tree
from repro_torch.compression.sparse import SparseGrad, decompress_tree
from repro_torch.configs import get_config
from repro_torch.core.steps import _apply_tree, init_state, make_train_step
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels.ops import adam_hyper_traced
from repro_torch.models.param import from_jax_params
from repro_torch.models.registry import build_model
from repro_torch.optim.adam import AdamState, adam_update
from test_torch_kernels import assert_adam_close

SHAPES = {"a": (3, 700), "b": {"w": (2048,), "z": (5,)}}
HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal(SHAPES["a"]) * scale).astype(np.float32),
            "b": {k: (rng.standard_normal(s) * scale).astype(np.float32)
                  for k, s in SHAPES["b"].items()}}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_compress_ef_update_same_gradient():
    """Same gradient, residual, params and moments in; the port's
    K1 -> K2 -> K4 path gives the reference's indices exactly, and
    values, residual, params and moments within tolerance."""
    rng = np.random.default_rng(0)
    grads, ef = _tree(rng), _tree(rng, 0.1)
    params, mu = _tree(rng), _tree(rng, 0.1)
    nu = jax.tree.map(lambda x: np.abs(x) * 0.01, _tree(rng))
    count = 4

    cg, ef2 = ef_compress_tree(_t(grads), _t(ef), 0.01)
    jcg, jef2 = jax_ef(jax.tree.map(jnp.asarray, grads),
                       jax.tree.map(jnp.asarray, ef), 0.01)
    for s, j in zip(tree_leaves(cg), jax.tree.leaves(jcg)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(j))
    # corrected = g + e is one f32 add in both; picked entries are then
    # exactly zero in the residual, the rest equal corrected
    for s, j in zip(tree_leaves(ef2), jax.tree.leaves(jef2)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(j))

    opt = AdamState(_t(mu), _t(nu), torch.tensor(count - 1,
                                                 dtype=torch.int32))
    hyper = adam_hyper_traced(count=opt.count + 1, **HYPER)
    p2, opt2 = _apply_tree(_t(params), cg, opt, hyper, opt.count + 1)
    jp2, jopt2 = jax_adam(jax.tree.map(jnp.asarray, params),
                          jax_decompress(jcg),
                          JaxAdam(jax.tree.map(jnp.asarray, mu),
                                  jax.tree.map(jnp.asarray, nu),
                                  jnp.asarray(count - 1, jnp.int32)),
                          **HYPER)
    dense = jax.tree.leaves(jax.tree.map(np.asarray, jax_decompress(jcg)))
    for i, (p, g, m, v) in enumerate(zip(jax.tree.leaves(params), dense,
                                         jax.tree.leaves(mu),
                                         jax.tree.leaves(nu))):
        assert_adam_close(
            [tree_leaves(p2)[i].numpy(), tree_leaves(opt2.mu)[i].numpy(),
             tree_leaves(opt2.nu)[i].numpy()],
            [jax.tree.leaves(jp2)[i], jax.tree.leaves(jopt2.mu)[i],
             jax.tree.leaves(jopt2.nu)[i]], p, g, m, v, hyper.numpy())
    assert int(opt2.count) == int(jopt2.count) == count


def test_fused_update_matches_plain_adam_update():
    """The port's lowdiff update (K4's plain version on the wire form)
    and its own ``adam_update`` on the decompressed gradient agree
    within 1e-6 — the reference's ``test_device_replay`` check."""
    rng = np.random.default_rng(7)
    params, g = _tree(rng), _tree(rng)
    mu = _tree(rng, 0.1)
    nu = jax.tree.map(lambda x: np.abs(x) * 0.01, _tree(rng))
    cg, _ = ef_compress_tree(_t(g), jax.tree.map(torch.zeros_like, _t(g)),
                             0.05)
    opt = AdamState(_t(mu), _t(nu), torch.zeros((), dtype=torch.int32))
    hyper = adam_hyper_traced(count=opt.count + 1, **HYPER)
    p2, opt2 = _apply_tree(_t(params), cg, opt, hyper, opt.count + 1)
    ep, est = adam_update(_t(params), decompress_tree(cg), opt, **HYPER)
    for a, b in zip(tree_leaves((p2, opt2.mu, opt2.nu)),
                    tree_leaves((ep, est.mu, est.nu))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    assert isinstance(tree_leaves(cg, is_leaf=lambda x: isinstance(
        x, SparseGrad))[0], SparseGrad)


@pytest.mark.parametrize("mode", ["lowdiff", "dense"])
def test_whole_step_matches_reference(mode):
    """One step from the same params and batch. The two gradients differ
    by summation-order rounding, so top-k may flip a near-tie: indices
    must agree in >= 99.9% of blocks, params are compared on the blocks
    that agree."""
    arch = "gpt2-l"
    jcfg = jax_config(arch).reduced()
    jm = jax_model(jcfg)
    jstate = jax_init_state(jm, jax.random.PRNGKey(2), mode=mode)
    cfg = get_config(arch).reduced()
    batch = make_batch(cfg, 64, 2, step=3)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jnew, jmet, jcg = jax_make_step(jm, mode=mode)(jstate, jbatch)

    model = build_model(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jstate["params"]),
                             model.specs)
    state = init_state(model, mode=mode, device="cpu", params=params)
    new, met, cg = make_train_step(model, mode=mode)(state, batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=2e-6)
    assert int(new["step"]) == int(jnew["step"]) == 1
    leaves = zip(tree_leaves(new["params"]), jax.tree.leaves(jnew["params"]))
    if mode == "dense":
        # a first Adam step moves each weight by lr*g/(|g|+eps'): the two
        # gradients' rounding differences stay far below lr except where
        # |g| is near eps, which amplifies them; every weight stays
        # within one step (lr) of the reference, and all but 1e-4 of
        # them within 2e-5
        for a, b in leaves:
            d = np.abs(a.numpy() - np.asarray(b))
            assert d.max() <= 1e-3
            assert (d > 2e-5).mean() <= 1e-4
        return
    agree = total = 0
    for (a, b), s, j in zip(leaves, [l for l in tree_leaves(cg)
                                     if l.dtype == torch.int32],
                            [l for l in jax.tree.leaves(jcg)
                             if l.dtype == jnp.int32]):
        rows = (s.numpy() == np.asarray(j)).all(axis=1)
        agree += int(rows.sum())
        total += rows.size
        n = a.numel()
        mask = np.repeat(rows, 1024)[:n]
        np.testing.assert_allclose(a.numpy().reshape(-1)[mask],
                                   np.asarray(b).reshape(-1)[mask],
                                   rtol=0, atol=2e-5)
    assert agree >= 0.999 * total, (agree, total)
