"""The other model families in the port (DeepSeekMoE / Qwen3-MoE, Hymba's
attention + Mamba hybrid, xLSTM, the Pixtral projector, the SeamlessM4T
encoder-decoder) against the JAX reference on the CPU, at reduced size
in f32: configs, parameter trees of all eleven architectures, batches
bit for bit, loss and gradients; the MoE router's ties, drop path, aux
loss and gradient accumulation; Hymba's mix of windowed and global
layers. Whole steps, chains and the CLI: ``test_torch_families_steps``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import _REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_config
from repro.core.steps import _grads as jax_grads
from repro.data.synthetic import make_batch as jax_batch
from repro.models import moe as jax_moe
from repro.models.lm import layer_windows as jax_windows
from repro.models.param import materialize
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.configs import (ASSIGNED_ARCHS, PORT_ONLY, _REGISTRY,
                                 get_config)
from repro_torch.configs.base import DTYPES, reference_fields
from repro_torch.core.steps import _differentiable, _grads, _micro
from repro_torch.data.synthetic import _f64_to, make_batch
from repro_torch.models import moe
from repro_torch.models.lm import layer_windows
from repro_torch.models.param import ParamSpec, from_jax_params
from repro_torch.models.param import materialize as torch_materialize
from repro_torch.models.registry import build_model

FAMILIES = ("deepseek-moe-16b", "qwen3-moe-235b-a22b", "hymba-1.5b",
            "xlstm-350m", "pixtral-12b", "seamless-m4t-medium")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (six workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jbatch(batch):
    return {k: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16
                           else v.numpy()) for k, v in batch.items()}


# ---------------------------------------------------------------- configs
def test_assigned_archs_are_the_references():
    """``ASSIGNED_ARCHS``: the registry without gpt2-l and the port's own
    entries (``PORT_ONLY``), in its order (the registry itself:
    ``test_torch_grad_accum``); the port's own entries build."""
    assert ASSIGNED_ARCHS == JAX_ASSIGNED
    assert set(ASSIGNED_ARCHS) | {"gpt2-l"} == set(_REGISTRY) - set(PORT_ONLY)
    assert not set(PORT_ONLY) & set(JAX_REGISTRY)
    for a in PORT_ONLY:
        assert build_model(get_config(a)).n_params() > 0


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal(arch, reduced):
    a, b = get_config(arch), jax_config(arch)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert reference_fields(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert a.active_param_count() == b.active_param_count()
    assert str(a.pdtype()).split(".")[-1] == str(b.pdtype())
    assert str(a.cdtype()).split(".")[-1] == str(b.cdtype())


def _ref_tree(cfg):
    """(dotted names, shapes) of the reference's parameter tree."""
    shapes = jax.tree.map(lambda s: tuple(s.shape),
                          jax_model(cfg).abstract_params())
    flat = jax.tree_util.tree_leaves_with_path(
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    return ([jax.tree_util.keystr(p, simple=True, separator=".")
             for p, _ in flat], [s for _, s in flat])


@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_param_names_and_shapes_at_full_size(arch):
    """All eleven architectures at full size: the module declares the
    reference's leaves (names and shapes, on the meta device), and its
    count is the reference's."""
    model = build_model(get_config(arch))
    names, shapes = _ref_tree(jax_config(arch))
    mine = dict((n, tuple(p.shape)) for n, p in model.named_parameters())
    assert sorted(mine) == sorted(names)
    assert [mine[n] for n in names] == shapes
    assert [tuple(s.shape) for s in tree_leaves(
        model.specs, is_leaf=lambda x: hasattr(x, "logical"))] == shapes
    assert model.n_params() == jax_model(jax_config(arch)).n_params()
    assert all(p.dtype == get_config(arch).pdtype()
               for p in model.parameters())


def test_full_width_counts():
    """The phase I sizes of ``chip_smoke.py``: arithmetic from the specs."""
    count = lambda a, **kw: build_model(  # noqa: E731
        get_config(a).replace(**kw)).n_params()
    assert count("deepseek-moe-16b", n_layers=2) == 1_595_156_480
    assert count("deepseek-moe-16b") == 16_879_568_896
    assert count("hymba-1.5b", n_layers=8,
                 global_attn_layers=(0, 3, 7)) == 486_969_200
    assert count("xlstm-350m") == 443_167_840
    assert count("pixtral-12b", n_layers=1) == 1_633_172_480
    assert count("seamless-m4t-medium") == 977_758_208
    assert count("qwen3-moe-235b-a22b", n_layers=1) == 3_732_418_560


# ---------------------------------------------------------------- batches
def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("reduced", [False, True])
def test_batches_bit_equal(arch, reduced):
    """Every input bit for bit, the frontend ones included: at full size
    Pixtral's and Seamless's are bf16 (compute dtype), reduced f32."""
    a, b = get_config(arch), jax_config(arch)
    if reduced:
        a, b = a.reduced(), b.reduced()
    mine = make_batch(a, 64, 3, step=5, seed=2)
    ref = jax_batch(b, 64, 3, step=5, seed=2)
    assert sorted(mine) == sorted(ref)
    want = {"vlm": {"patch_embeds", "loss_mask"},
            "audio": {"src_embeds"}}.get(a.arch_type, set())
    assert set(mine) == {"tokens", "targets"} | want
    for k in mine:
        x, y = _bits(mine[k]), _bits(ref[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        assert x.tobytes() == y.tobytes(), k


def test_bf16_inputs_round_as_jax_does():
    """``jnp.asarray(x, bf16)`` of an f64 rounds through f32, so twice:
    1.003906296641184 (1 + 2^-8 + 3.5e-8, just above a bf16 halfway
    point; drawn by Pixtral's batch of seed 2, step 5) lands on the
    halfway point in f32 and rounds down to even, where one rounding
    would go up. The port's cast gives JAX's bits on it and on
    ordinary normals, ties and negatives."""
    x = np.array([1.003906296641184, 1 + 2 ** -8, 1 + 3 * 2 ** -8,
                  -1.003906296641184, 1e-3, -7.5, 0.0])
    x = np.concatenate([x, np.random.default_rng(0).normal(size=4096)])
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    got = _f64_to(x, torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.int16(0x3F80)           # 1.0, not 1 + 2^-7
    np.testing.assert_array_equal(
        _f64_to(x, torch.float32).numpy(),
        np.asarray(jnp.asarray(x, jnp.float32)))


# ---------------------------------------------------------- loss, grads
def _jax_loss_grads(cfg, batch, seed=1):
    jm = jax_model(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    (loss, met), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        params, _jbatch(batch))
    return (jax.tree.map(np.asarray, params), float(loss),
            {k: float(v) for k, v in met.items()},
            jax.tree.map(np.asarray, grads))


def _assert_grads(grads, ref):
    """Each gradient leaf within 1e-4 of its own largest magnitude (f32;
    the frameworks sum in different orders), as
    ``test_torch_data_model`` holds the dense LMs."""
    ref = jax.tree.leaves(ref)
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        scale = float(np.abs(r).max()) + 1e-12
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=1e-4 * scale)


def _loss_and_grads(model, params_np, batch):
    params = from_jax_params(params_np, model.specs)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, met = model.loss_fn(params, batch)
    return loss, met, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """Loss within 2e-6 relative and every gradient leaf within 1e-4 of
    its scale, from the reference's initial params; the metrics carry
    the reference's keys and values; the module's own forward is the
    same function."""
    cfg = get_config(arch).reduced()
    batch = make_batch(cfg, 64, 2, step=1)
    params_np, jloss, jmet, jgrads = _jax_loss_grads(
        jax_config(arch).reduced(), batch)
    model = build_model(cfg)
    loss, met, grads = _loss_and_grads(model, params_np, batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-6)
    assert sorted(met) == sorted(jmet) == ["aux", "tokens", "xent"]
    np.testing.assert_allclose(float(met["xent"]), jmet["xent"], rtol=2e-6)
    np.testing.assert_allclose(float(met["aux"]), jmet["aux"], rtol=1e-6)
    assert float(met["tokens"]) == jmet["tokens"]
    _assert_grads(grads, jgrads)
    model.load_params(from_jax_params(params_np))
    with torch.no_grad():
        assert float(model(batch)[0]) == float(loss.detach())


def test_vlm_loss_skips_the_patch_positions():
    """Pixtral's loss counts only the text positions: the loss mask zeros
    the P patch positions, whose embeddings are the projector's."""
    cfg = get_config("pixtral-12b").reduced()
    batch = make_batch(cfg, 64, 2, step=3)
    P = batch["patch_embeds"].shape[1]
    assert P == 16 and batch["loss_mask"][:, :P].sum() == 0
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    _, met = model.loss_fn(params, batch)
    assert float(met["tokens"]) == 2 * (64 - P)
    # the patch positions see the projector: changing it moves the loss
    params["projector"] = params["projector"] * 2
    assert float(model.loss_fn(params, batch)[1]["xent"]) != \
        float(met["xent"])


# -------------------------------------------------------------------- MoE
def _moe_inputs(arch="deepseek-moe-16b", T=64, **moe_kw):
    cfg = get_config(arch).reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    jcfg = jax_config(arch).reduced()
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
    r = np.random.default_rng(7)
    jp = materialize(jax.random.PRNGKey(3), jax_moe.moe_specs(jcfg, 1),
                     jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a)[0], jp)
    x = r.normal(size=(2, T // 2, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, x


def _ref_route(jp, x, jcfg):
    """The reference's routing lines (``repro/models/moe.py:79-100``) on
    the same inputs: (eid, dest, valid)."""
    m = jcfg.moe
    E, K = m.n_experts, m.top_k
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    T = xf.shape[0]
    C = jax_moe.capacity(T, jcfg)
    probs = jax.nn.softmax(xf @ jnp.asarray(jp["router"]), axis=-1)
    _, eid = jax.lax.top_k(probs, K)
    oh_flat = jax.nn.one_hot(eid, E, dtype=jnp.float32).reshape(T * K, E)
    pos = jnp.cumsum(oh_flat, axis=0) - oh_flat
    pos_in_e = jnp.einsum("ae,ae->a", pos, oh_flat).astype(jnp.int32)
    valid = pos_in_e < C
    dest = jnp.where(valid, eid.reshape(T * K) * C + pos_in_e, E * C)
    return np.asarray(eid), np.asarray(dest), np.asarray(valid)


def _port_moe(jp, x, cfg):
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return moe.moe_apply(p, torch.from_numpy(x), cfg), p


def test_router_ties_pick_the_lowest_experts():
    """A zero router makes every probability equal: ``jax.lax.top_k``
    picks experts 0..K-1 for every token, and so must the port (whose
    ``torch.topk`` promises no order among ties); the outputs agree."""
    cfg, jcfg, jp, x = _moe_inputs()
    jp["router"] = np.zeros_like(jp["router"])
    K = cfg.moe.top_k
    eid, dest, _ = _ref_route(jp, x, jcfg)
    assert (eid == np.arange(K)).all()
    C = moe.capacity(x.shape[0] * x.shape[1], cfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    _, meid, mdest, _, _ = moe.route(p, torch.from_numpy(x).reshape(
        -1, cfg.d_model), cfg, C)
    np.testing.assert_array_equal(meid.numpy(), eid)
    np.testing.assert_array_equal(mdest.numpy(), dest)
    (y, aux), _ = _port_moe(jp, x, cfg)
    jy, jaux = jax_moe._moe_apply_dense(jax.tree.map(jnp.asarray, jp),
                                        jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    vals, idx = moe.top_k(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_drop_path_matches_reference(arch):
    """``capacity_factor=1.0`` (the reduced configs are drop-free): some
    assignments overflow their expert and go to the drop slot. The
    port's eid and dest equal the reference's, and so does the output,
    with and without the shared expert; its gradients too."""
    cfg, jcfg, jp, x = _moe_inputs(arch, T=64, capacity_factor=1.0)
    eid, dest, valid = _ref_route(jp, x, jcfg)
    C = moe.capacity(64, cfg)
    E = cfg.moe.n_experts
    assert (~valid).sum() > 0 and (dest == E * C).sum() == (~valid).sum()
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    _, meid, mdest, mvalid, _ = moe.route(p, torch.from_numpy(x).reshape(
        -1, cfg.d_model), cfg, C)
    np.testing.assert_array_equal(meid.numpy(), eid)
    np.testing.assert_array_equal(mdest.numpy(), dest)
    np.testing.assert_array_equal(mvalid.numpy(), valid)
    jpj = jax.tree.map(jnp.asarray, jp)
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jf(pp, xx):
        y, aux = jax_moe._moe_apply_dense(pp, xx, jcfg)
        return (y * w).sum() + aux, (y, aux)
    (_, (jy, jaux)), jg = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(jpj, jnp.asarray(x))
    pt = {k: v.requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(pt, xt, cfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    names = sorted(pt)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                                [pt[k] for k in names] + [xt])
    _assert_grads(list(grads), [jg[0][k] for k in names] + [jg[1]])


def test_aux_loss_enters_the_loss():
    """``loss = xent + router_aux_weight * aux``, with aux the sum over
    layers of ``E * sum(frac * mean prob)`` (1 when balanced)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    model = build_model(cfg)
    params = model.init(2, device="cpu")
    loss, met = model.loss_fn(params, make_batch(cfg, 64, 2, step=4))
    assert float(met["aux"]) > 0.5 * cfg.n_layers
    assert float(loss) == float(met["xent"] + cfg.moe.router_aux_weight
                                * met["aux"])


@pytest.mark.parametrize("arch,accum,acc_dtype", [
    ("deepseek-moe-16b", 2, "float32"),
    ("qwen3-moe-235b-a22b", 4, "bfloat16"),
    ("pixtral-12b", 2, "float32"),
    ("seamless-m4t-medium", 2, "float32")])
def test_grads_accumulate_like_reference(arch, accum, acc_dtype):
    """``_grads`` with the configs' own accumulation (DeepSeekMoE 2 in
    f32, Qwen3-MoE 4 in bf16; Pixtral's and Seamless's frontend inputs
    split along the batch as the tokens), against the reference's on the
    same params and batch of 4 rows: ``test_torch_grad_accum``'s
    tolerances (1e-4 of each leaf's scale, plus one bf16 ulp of it per
    micro-batch with the bf16 buffer, where >= 99.9% of the elements are
    bitwise equal)."""
    kw = dict(grad_accum=accum, grad_accum_dtype=acc_dtype)
    jm = jax_model(jax_config(arch).reduced().replace(**kw))
    m = build_model(get_config(arch).reduced().replace(**kw))
    jp = jm.init(jax.random.PRNGKey(1))
    batch = make_batch(m.cfg, 64, 4, step=1)
    for k, x in batch.items():
        assert torch.equal(_micro(batch, accum, 1)[k],
                           x[4 // accum:2 * 4 // accum])
    jloss, jmet, jg = jax_grads(jm, jp, _jbatch(batch), accum)
    params = from_jax_params(jax.tree.map(np.asarray, jp), m.specs)
    loss, met, g = _grads(m, params, batch, accum)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
    assert sorted(met) == sorted(jmet)
    same = total = 0
    for x, y in zip(tree_leaves(g), jax.tree.leaves(jg)):
        assert x.dtype == DTYPES[acc_dtype]
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


def test_stacked_subtrees_take_per_layer_leaves():
    """Every stacked per-layer subtree (``layers``; the encoder-decoder's
    ``enc_layers`` and ``dec_layers``) is handed to the model as per-layer
    autograd leaves; the top-level leaves stay whole."""
    model = build_model(get_config("seamless-m4t-medium").reduced())
    params = model.init(0, device="cpu")
    live, leaves, _ = _differentiable(params, model.specs)
    for k in ("enc_layers", "dec_layers"):
        wq = live[k]["attn" if k == "enc_layers" else "self_attn"]["wq"]
        assert isinstance(wq, list) and len(wq) == 2
    assert isinstance(live["embed"], torch.Tensor)
    n_stacked = sum(1 for k in ("enc_layers", "dec_layers")
                    for _ in tree_leaves(params[k]))
    assert len(leaves) == len(tree_leaves(params)) + n_stacked


#: the rule ``is_stacked`` replaced: the top-level keys of the stacks
STACK_KEYS = {"layers", "dense_layers", "enc_layers", "dec_layers"}


def _paths(tree, leaf, path=()):
    """Paths of the nodes of a nested dict for which ``leaf`` holds."""
    if leaf(tree):
        return {path}
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _paths(v, leaf, path + (k,))}
    return set()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(_REGISTRY))
def test_stacked_split_is_the_stack_keys(arch, reduced):
    """The leaves ``_differentiable`` splits per layer, read from the
    specs' first logical axis, are exactly the leaves under the stacks'
    top-level keys, in every registry config (specs only, on ``meta``)."""
    cfg = get_config(arch)
    model = build_model(cfg.reduced() if reduced else cfg)
    params = model.abstract_params()
    live, leaves, regroup = _differentiable(params, model.specs)
    split = _paths(live, lambda x: isinstance(x, list))
    whole = _paths(params, lambda x: isinstance(x, torch.Tensor))
    assert split == {p for p in whole if p[0] in STACK_KEYS}
    grads = regroup(leaves)
    assert [g.shape for g in grads] == [p.shape for p in tree_leaves(params)]


def test_stack_under_an_unnamed_key_is_split():
    """A stack under a top-level key no module names is split per layer
    all the same, and its regrouped gradient is the stacked one."""
    specs = {"embed": ParamSpec((8, 4), ("vocab", "embed")),
             "towers": {"norm": ParamSpec((3, 4), ("layers", "embed")),
                        "w": ParamSpec((3, 4, 2), ("layers", "embed", "mlp"))}}
    params = torch_materialize(torch.Generator().manual_seed(0), specs,
                         torch.float32, "cpu")
    live, leaves, regroup = _differentiable(params, specs)
    assert isinstance(live["embed"], torch.Tensor)
    for k, L in (("norm", 3), ("w", 3)):
        assert isinstance(live["towers"][k], list)
        assert len(live["towers"][k]) == L
    loss = live["embed"].sum() + sum(
        (i + 1) * w.sum() for i, w in enumerate(live["towers"]["w"]))
    grads = regroup(list(torch.autograd.grad(loss, leaves,
                                             allow_unused=True,
                                             materialize_grads=True)))
    want = torch.arange(1, 4, dtype=torch.float32)[:, None, None]
    assert torch.equal(grads[2], want.expand(3, 4, 2))
    assert grads[1].shape == (3, 4) and not grads[1].any()


# ---------------------------------------------------------------- hybrid
def test_hybrid_mixes_windowed_and_global_layers():
    """A reduced Hymba stack of 4 layers, global attention at 0 and 2 and
    a 32-token window elsewhere, on 128 tokens (so the window binds and
    the Mamba scan runs 8 chunks of 16): windows, loss and gradients
    equal the reference's, and the window matters."""
    kw = dict(n_layers=4, global_attn_layers=(0, 2))
    cfg = get_config("hymba-1.5b").reduced().replace(**kw)
    jcfg = jax_config("hymba-1.5b").reduced().replace(**kw)
    assert layer_windows(cfg).tolist() == jax_windows(jcfg).tolist() == \
        [0, 32, 0, 32]
    batch = make_batch(cfg, 128, 2, step=2)
    params_np, jloss, _, jgrads = _jax_loss_grads(jcfg, batch, seed=4)
    model = build_model(cfg)
    loss, _, grads = _loss_and_grads(model, params_np, batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-6)
    _assert_grads(grads, jgrads)
    full = build_model(cfg.replace(sliding_window=0))
    with torch.no_grad():
        other = full.loss_fn(from_jax_params(params_np), batch)[0]
    assert abs(float(other) - float(loss)) > 1e-6
