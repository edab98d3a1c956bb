"""The port's sharding layouts against the JAX reference's, in one
process, with no process group: the partition spec of every parameter
and every decode-cache leaf of all eleven architectures under both rule
sets on the (1,1), (2,2), (16,16) and (2,16,16) meshes, ``pspec_tree``,
``effective_accum`` over a grid, ``input_specs``, ``abstract_params`` on
the ``meta`` device, the mesh-following shard splitter (shard files
byte-identical), DTensor placements, block slices and the shard-local
compression's row order on abstract meshes.

The reference's layout functions read only a mesh's axis names and
device-array shape, so its specs are computed on stand-in meshes of
those shapes (this process has one JAX device)."""
import itertools
import types

import numpy as np
import pytest
import torch

import repro.distributed.sharding as jshd
from repro.checkpoint.backends import ShardedBackend as JaxSharded
from repro.checkpoint.backends import make_pspec_splitter as jax_splitter
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.data.synthetic import input_specs as jax_input_specs
from repro.distributed import step_builder as jsb
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.checkpoint import ShardedBackend, make_pspec_splitter
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.data.synthetic import input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import step_builder as sb
from repro_torch.launch.mesh import (AbstractMesh, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models.registry import build_model

torch.set_num_threads(1)

MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


def _jax_mesh(shape, axes):
    """A stand-in for ``jax.sharding.Mesh``: what the layout code reads."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _port_mesh(shape, axes):
    if shape == (16, 16):
        return make_production_mesh()
    if shape == (2, 16, 16):
        return make_production_mesh(multi_pod=True)
    return make_local_mesh(*shape)


def _jax_specs(ctx, mesh, leaves, logical):
    return [tuple(jshd.safe_spec(l.shape, ctx.spec(lg), mesh))
            for l, lg in zip(leaves, logical)]


def _logical_leaves(tree, struct_leaves):
    """Logical tuples of ``tree`` in leaf order (dict keys sorted,
    NamedTuple fields in order, () fields empty)."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for v in t:
                walk(v)
        elif isinstance(t, tuple) and (not t or all(
                x is None or isinstance(x, str) for x in t)):
            if t:
                out.append(t)
        else:
            for v in t:
                walk(v)
    walk(tree)
    assert len(out) == len(struct_leaves)
    return out


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_safe_specs_equal_the_reference(arch):
    """Every param leaf's and every cache leaf's safe spec, both rule
    sets, four meshes: equal to the reference's as tuples."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    model, jmodel = build_model(cfg), jax_model(jcfg)
    p_abs = tree_leaves(model.abstract_params())
    jp_abs = __import__("jax").tree.leaves(jmodel.abstract_params())
    assert [tuple(t.shape) for t in p_abs] == [tuple(s.shape) for s in jp_abs]
    p_log = _logical_leaves(model.logical_axes(), p_abs)
    B, S = 32, 4096
    c_abs = tree_leaves(model.init_cache(B, S, device="meta"))
    jc_abs = __import__("jax").tree.leaves(
        jmodel.init_cache(B, S, abstract=True))
    assert [tuple(t.shape) for t in c_abs] == [tuple(s.shape) for s in jc_abs]
    c_log = _logical_leaves(model.cache_logical(), c_abs)
    assert c_log == _logical_leaves(jmodel.cache_logical(), jc_abs)
    n = 0
    for (shape, axes), kind in itertools.product(MESHES.items(),
                                                 ("train", "decode")):
        rules = cfg.rules(kind)
        assert rules == jcfg.rules(kind)
        jm = _jax_mesh(shape, axes)
        jctx = jshd.MeshContext(jm, rules)
        mesh = _port_mesh(shape, axes)
        assert shd.mesh_shape(mesh) == dict(zip(axes, shape))
        with shd.use_mesh(mesh, rules) as ctx:
            for leaves, logical in ((p_abs, p_log), (c_abs, c_log)):
                got = [tuple(shd.safe_spec(l.shape, ctx.spec(lg), mesh))
                       for l, lg in zip(leaves, logical)]
                assert got == _jax_specs(jctx, jm, leaves, logical), \
                    (shape, kind)
                n += len(got)
            # the tree functions give the same specs
            psh = sb.param_shardings(model)
            assert [tuple(s) for s in shd.spec_leaves(psh)] == \
                _jax_specs(jctx, jm, p_abs, p_log)
    assert n > 0


def test_safe_spec_keeps_the_longest_dividing_prefix():
    mesh = AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    assert tuple(shd.safe_spec((8, 50257), shd.P(("pod", "data"), "model"),
                               mesh)) == (("pod", "data"), None)
    assert tuple(shd.safe_spec((6, 8), shd.P(("pod", "data"), None),
                               mesh)) == ("pod", None)
    assert tuple(shd.safe_spec((3,), shd.P("data"), mesh)) == (None,)
    jm = _jax_mesh((2, 4, 2), ("pod", "data", "model"))
    for shape in [(8, 50257), (6, 8), (16, 10), (1, 2)]:
        for spec in [(("pod", "data"), "model"), ("data", ("model",)),
                     (None, ("data", "model"))]:
            assert tuple(shd.safe_spec(shape, shd.P(*spec), mesh)) == \
                tuple(jshd.safe_spec(shape, jshd.P(*spec), jm))


def test_spec_skips_used_axes_and_use_mesh_nests():
    """An axis taken by an earlier dim is left out of a later one; the
    context is thread-local and nests."""
    import threading
    outer, inner = make_local_mesh(2, 2), make_local_mesh(1, 4)
    assert shd.current() is None
    with shd.use_mesh(outer, {"mlp": ("data", "model")}) as a:
        assert tuple(a.spec(("batch", "mlp", "heads"))) == \
            ("data", "model", None)
        seen = []
        t = threading.Thread(target=lambda: seen.append(shd.current()))
        t.start()
        t.join(timeout=10)
        assert seen == [None]
        with shd.use_mesh(inner) as b:
            assert shd.current() is b and shd.mesh_shape(b.mesh)["model"] == 4
        assert shd.current() is a
    assert shd.current() is None


def test_pspec_tree_equals_the_reference():
    cfg = get_config("gpt2-l")
    model, jmodel = build_model(cfg), jax_model(jax_config("gpt2-l"))
    none = shd.pspec_tree(model.logical_axes())
    assert all(tuple(s) == () for s in shd.spec_leaves(none))
    with shd.use_mesh(make_local_mesh(1, 1)):
        got = shd.pspec_tree(model.logical_axes())
    with jshd.use_mesh(jax_local_mesh(1, 1)):
        want = jshd.pspec_tree(jmodel.logical_axes())
    import jax
    assert [tuple(s) for s in shd.spec_leaves(got)] == \
        [tuple(s) for s in jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, jshd.P))]
    with shd.use_mesh(make_local_mesh(2, 2)):
        sh = shd.sharding_tree(model.logical_axes())
    wo = sh["layers"]["attn"]["wo"]
    from torch.distributed.tensor import Replicate, Shard
    assert tuple(wo.spec) == (None, "model", "data")
    assert wo.placements == (Shard(2), Shard(1))
    assert sh["final_norm"].placements == (Replicate(), Replicate())


def test_effective_accum_over_a_grid():
    for accum, gb, dp in itertools.product(range(1, 9), (1, 2, 3, 4, 6, 8,
                                                          12, 16, 64, 256),
                                           (1, 2, 4, 8, 16, 32)):
        assert sb.effective_accum(accum, gb, dp) == \
            jsb.effective_accum(accum, gb, dp)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in INPUT_SHAPES.items():
        got = input_specs(cfg, shape)
        want = jax_input_specs(jcfg, JAX_SHAPES[name])
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_abstract_params_allocate_nothing():
    """llama3-405b's 810 GB of params and its whole abstract state exist
    only as meta tensors, with their shardings attached."""
    cfg = get_config("llama3-405b")
    model = build_model(cfg)
    params = model.abstract_params()
    leaves = tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == model.n_params()
    with shd.use_mesh(make_production_mesh(), cfg.rules("train")):
        st = sb.abstract_state(model, mode="lowdiff", error_feedback=True)
        ab = sb.abstract_batch(model, INPUT_SHAPES["train_4k"])
    sl = tree_leaves(st)
    assert all(t.device.type == "meta" and hasattr(t, "sharding")
               for t in sl)
    assert sum(t.numel() for t in sl) == 4 * model.n_params() + 2
    assert tuple(ab["tokens"].sharding.spec) == ("data", None)


def test_block_slices_and_local_shapes():
    mesh = make_local_mesh(2, 4)
    spec = shd.P(None, ("data", "model"))
    x = torch.arange(3 * 16).reshape(3, 16)
    parts = []
    for d, m in itertools.product(range(2), range(4)):
        sl = shd.block_slices(x.shape, spec, mesh, {"data": d, "model": m})
        assert tuple(x[sl].shape) == (3, 2)
        parts.append((d * 4 + m, x[sl]))
    assert torch.equal(torch.cat([p for _, p in sorted(parts, key=lambda
                                                         t: t[0])], 1), x)


def test_compress_sharded_rows_follow_out_spec():
    """On an abstract (2,4) mesh each distinct block is compressed once
    and the rows concatenate over the spec's axes in the spec's order:
    wo (model, data) and wq (data, model) of gpt2-l's layout."""
    mesh = make_local_mesh(2, 4)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 64, 1024)).astype(np.float32))
    for spec, order in ((shd.P(None, "model", "data"), ("model", "data")),
                        (shd.P(None, "data", "model"), ("data", "model")),
                        (shd.P(None, None, "model"), ("model",)),
                        (shd.P(), ())):
        sg = tree_leaves(sb.compress_sharded({"g": g}, {"g": spec}, mesh,
                                             0.01), is_leaf=lambda x: hasattr(
            x, "indices"))[0]
        from repro_torch.kernels import ref
        want_v, want_i = [], []
        sizes = shd.mesh_shape(mesh)
        for c in itertools.product(*(range(sizes[a]) for a in order)):
            coord = {"data": 0, "model": 0}
            coord.update(zip(order, c))
            blk = g[shd.block_slices(g.shape, spec, mesh, coord)]
            xb, _ = ref.to_blocks(blk.contiguous(), 1024)
            v, i = ref.topk_select_ref(xb, 11)
            want_v.append(v)
            want_i.append(i)
        assert torch.equal(sg.values, torch.cat(want_v))
        assert torch.equal(sg.indices, torch.cat(want_i))
        assert tuple(sg.shape) == tuple(g.shape)


def test_abstract_steps_need_a_live_mesh():
    cfg = get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)
    with shd.use_mesh(make_local_mesh(2, 2)):
        step, st, b = sb.make_sharded_train_step(model,
                                                 INPUT_SHAPES["train_4k"])
        with pytest.raises(RuntimeError, match="live mesh"):
            step({}, {})
        _, _, cache, _ = sb.make_sharded_serve_step(
            model, INPUT_SHAPES["decode_32k"])
    assert tree_leaves(cache)[0].device.type == "meta"


# ----------------------------------------------------------------------
# the mesh-following shard splitter
# ----------------------------------------------------------------------

def test_pspec_splitter_follows_mesh():
    """Twin of the reference's ``test_pspec_splitter_follows_mesh``."""
    splitter = make_pspec_splitter({(8, 64): ("embed", "mlp")})
    with shd.use_mesh(make_local_mesh(1, 1)):
        splitter2 = make_pspec_splitter({(128, 16): (None, "mlp")})
        assert splitter2(np.zeros((128, 16), np.float32)) == 1
        assert splitter(np.zeros((8, 64), np.float32)) == 1
    assert splitter2(np.zeros((128, 16), np.float32)) == 0


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_pspec_split_shard_files_match_the_reference(tmp_path, shape):
    """The same tree through both packages' ShardedBackend with their
    mesh-following splitters: meta JSON equal, shard files identical."""
    import json
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(128, 64)).astype(np.float32),
            "b": rng.normal(size=(256, 96)).astype(np.float32),
            "c": np.arange(7, dtype=np.int32)}
    logical = {(128, 64): ("mlp", "fsdp"), (256, 96): (None, "heads")}
    mine = ShardedBackend(str(tmp_path / "mine"), 3,
                          split_threshold_bytes=1024,
                          split_axis_fn=make_pspec_splitter(logical))
    theirs = JaxSharded(str(tmp_path / "theirs"), 3,
                        split_threshold_bytes=1024,
                        split_axis_fn=jax_splitter(logical))
    with shd.use_mesh(make_local_mesh(*shape)):
        mine.put("full_00000001", {k: torch.from_numpy(v)
                                   for k, v in tree.items()})
    prev = getattr(jshd._TLS, "ctx", None)
    jshd._TLS.ctx = jshd.MeshContext(_jax_mesh(shape, ("data", "model")))
    try:
        theirs.put("full_00000001", tree)
    finally:
        jshd._TLS.ctx = prev
    with open(mine._meta_path("full_00000001")) as f:
        meta = json.load(f)
    with open(theirs._meta_path("full_00000001")) as f:
        assert meta == json.load(f)
    axes = sorted({p.get("axis") for p in meta["placements"]
                   if p["kind"] == "split"})
    assert axes == [0, 1]
    for k in meta["shards"]:
        a = mine._find_shard(k, "full_00000001")
        b = theirs._find_shard(k, "full_00000001")
        assert open(a, "rb").read() == open(b, "rb").read()
    got = mine.get("full_00000001")
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    mine.close()
    theirs.close()
