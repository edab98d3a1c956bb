"""The port's sharded steps (``distributed.step_builder``) on
``torch.distributed`` against the reference's pjit steps and against the
port's own unsharded steps, on reduced qwen2-1.5b (f32).

The reference runs in a subprocess on 4 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``); the port runs
4 gloo ranks in subprocesses on a (data 2, model 2) mesh and a world of
one rank on (1, 1), each group initialised through a ``FileStore``. All
start from the same numpy params and gradient bytes. Checked:

* ``compress_sharded`` of the same gradient: values and indices equal
  bit for bit to the reference's ``shard_map`` output, under the default
  rules (wq split (data, model), wo (model, data)) and qwen2's training
  overrides (FSDP over data x model); the abstract-mesh path, compressing
  rank by rank in one process, gives the same rows;
* two ``dense`` and two ``lowdiff_sharded`` steps: the state within
  ``STATE_TOL`` of the reference's sharded step and of the port's
  unsharded step, the loss within ``LOSS_TOL``, and >= 99.9% of the
  top-k picks equal;
* the ``lowdiff`` mode passed through (error feedback, each global leaf
  compressed) against the unsharded lowdiff step, as above;
* a world of one rank: bit for bit equal to the unsharded steps, the
  unsharded ``compress_tree`` payload, ``logits_fn`` and ``decode_step``;
* the sharded prefill and serve steps on (2, 2) against ``logits_fn``
  and ``decode_step`` within ``LOGIT_TOL``, the serve step also with
  Hymba's, xLSTM's and Seamless's cache trees.

Tolerances: sums over data shards reassociate, which moves gradients by
~1e-7 relative; Adam divides by sqrt(nu) + eps, so where a gradient is
near eps the first step moves a parameter by up to lr (1e-3), as
``ROADMAP.md`` states for the reference's fused Adam. So per element
``STATE_TOL`` = 2 steps x lr, and >= 99.9% of elements within 1e-5."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
LR = 1e-3
STATE_TOL = 2 * LR
CLOSE, CLOSE_SHARE = 1e-5, 0.999
LOSS_TOL = 1e-5
LOGIT_TOL = 1e-4
MODES = ("dense", "lowdiff_sharded")
#: decode-cache trees beside the KV cache's, for the serve step
FAMILIES = ("hymba-1.5b", "xlstm-350m", "seamless-m4t-medium")
RULES = ("default", "train")

COMMON = textwrap.dedent("""
    import sys
    import numpy as np
    inp = np.load(sys.argv[-2])
    out = {}
    SHAPE = dict(seq=16, batch=8)
    FAMILIES = %r
""" % (FAMILIES,))

JAX_SCRIPT = COMMON + textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from repro.compression.sparse import SparseGrad
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.data.synthetic import make_batch
    from repro.distributed import sharding as shd, step_builder as sb
    from repro.launch.mesh import make_local_mesh
    from repro.models.registry import build_model
    from repro.optim.adam import adam_init
    cfg = get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)
    treedef = jax.tree.structure(model.abstract_params())
    n = treedef.num_leaves
    params = treedef.unflatten([jnp.asarray(inp[f"p{i}"]) for i in range(n)])
    grads = treedef.unflatten([jnp.asarray(inp[f"g{i}"]) for i in range(n)])
    mesh = make_local_mesh(2, 2)
    is_sg = lambda x: isinstance(x, SparseGrad)
    for tag, rules in (("default", {}), ("train", cfg.rules("train"))):
        with shd.use_mesh(mesh, rules):
            psh = sb.param_shardings(model)
            pspecs = jax.tree.map(lambda s: s.spec, psh)
            cg = sb.compress_sharded(jax.device_put(grads, psh), pspecs,
                                     mesh, 0.01)
            for i, l in enumerate(jax.tree.leaves(cg, is_leaf=is_sg)):
                out[f"{tag}_cv{i}"] = np.asarray(l.values)
                out[f"{tag}_ci{i}"] = np.asarray(l.indices)
    shape = ShapeConfig("t", SHAPE["seq"], SHAPE["batch"], "train")
    with shd.use_mesh(mesh, {}):
        for mode in ("dense", "lowdiff_sharded"):
            step, _, _ = sb.make_sharded_train_step(model, shape, mode=mode,
                                                    donate=False)
            st_sh = sb.state_shardings(model, mode=mode,
                                       error_feedback=False)
            state = jax.device_put({"params": params,
                                    "opt": adam_init(params),
                                    "step": jnp.zeros((), jnp.int32)}, st_sh)
            for s in range(2):
                state, met, cg = step(state, make_batch(
                    cfg, SHAPE["seq"], SHAPE["batch"], step=s))
                out[f"{mode}_loss{s}"] = np.asarray(met["loss"])
            for k, tree in (("p", state["params"]), ("mu", state["opt"].mu),
                            ("nu", state["opt"].nu)):
                for i, l in enumerate(jax.tree.leaves(tree)):
                    out[f"{mode}_{k}{i}"] = np.asarray(l)
            if cg is not None:
                for i, l in enumerate(jax.tree.leaves(cg, is_leaf=is_sg)):
                    out[f"{mode}_cv{i}"] = np.asarray(l.values)
                    out[f"{mode}_ci{i}"] = np.asarray(l.indices)
    np.savez(sys.argv[-1], **out)
""")

PORT_SCRIPT = COMMON + textwrap.dedent("""
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch import tree_leaves, tree_map
    from repro_torch.compression.sparse import SparseGrad, compress_tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.steps import init_state, make_train_step
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step_builder as sb
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    cfg = get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)

    def load(prefix):
        it = iter(range(10 ** 6))
        return tree_map(lambda _: torch.from_numpy(inp[f"{prefix}{next(it)}"]),
                        model.abstract_params())
    params, grads = load("p"), load("g")
    mesh = make_local_mesh(*((2, 2) if world == 4 else (1, 1)))
    assert shd.is_live(mesh)
    is_sg = lambda x: isinstance(x, SparseGrad)
    is_sh = lambda x: isinstance(x, shd.NamedSharding)

    def save_cg(tag, cg):
        for i, l in enumerate(tree_leaves(cg, is_leaf=is_sg)):
            out[f"{tag}_cv{i}"] = l.values.numpy()
            out[f"{tag}_ci{i}"] = l.indices.numpy()

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    for tag, rules in (("default", {}), ("train", cfg.rules("train"))):
        with shd.use_mesh(mesh, rules):
            psh = sb.param_shardings(model)
            pspecs = tree_map(lambda s: s.spec, psh, is_leaf=is_sh)
            cg = sb.compress_sharded(sb.shard_tree(grads, psh), pspecs,
                                     mesh, 0.01)
            save_cg(tag, sb.gather_compressed(cg, pspecs, mesh))
    shape = ShapeConfig("t", SHAPE["seq"], SHAPE["batch"], "train")
    batches = [make_batch(cfg, SHAPE["seq"], SHAPE["batch"], step=s)
               for s in range(2)]
    with shd.use_mesh(mesh, {}):
        psh = sb.param_shardings(model)
        pspecs = tree_map(lambda s: s.spec, psh, is_leaf=is_sh)
        for mode in ("dense", "lowdiff_sharded", "lowdiff"):
            ef = mode == "lowdiff"
            step, _, _ = sb.make_sharded_train_step(model, shape, mode=mode,
                                                    error_feedback=ef)
            st_sh = sb.state_shardings(model, mode=mode, error_feedback=ef)
            state0 = init_state(model, mode=mode, device="cpu",
                                params=params)
            local = sb.shard_tree(state0, st_sh)
            ref_step = make_train_step(model, mode={
                "dense": "dense", "lowdiff_sharded": "lowdiff_plus",
                "lowdiff": "lowdiff"}[mode])
            ref = state0
            for s, b in enumerate(batches):
                local, met, cg = step(local, b)
                ref, rmet, extra = ref_step(ref, b)
                out[f"{mode}_loss{s}"] = met["loss"].numpy()
                out[f"{mode}_uloss{s}"] = rmet["loss"].numpy()
            whole = sb.gather_tree(local, st_sh)
            for k, tree, rtree in (
                    ("p", whole["params"], ref["params"]),
                    ("mu", whole["opt"].mu, ref["opt"].mu),
                    ("nu", whole["opt"].nu, ref["opt"].nu),
                    ("ef", whole.get("ef", {}), ref.get("ef", {}))):
                for i, (l, r) in enumerate(zip(tree_leaves(tree),
                                               tree_leaves(rtree))):
                    out[f"{mode}_{k}{i}"] = l.numpy()
                    out[f"{mode}_u{k}{i}"] = r.numpy()
            out[f"{mode}_state_bitwise"] = np.array(same(whole, ref))
            if cg is not None:
                # lowdiff passes through: its payload is already whole
                full = cg if ef else sb.gather_compressed(cg, pspecs, mesh)
                save_cg(mode, full)
                ucg = extra if ef else compress_tree(extra, 0.01)
                save_cg(f"{mode}_u", ucg)
                out[f"{mode}_cg_bitwise"] = np.array(same(full, ucg))
        # prefill and serve
        pre, _, _ = sb.make_sharded_prefill_step(
            model, ShapeConfig("p", SHAPE["seq"], SHAPE["batch"], "prefill"))
        local_p = sb.shard_tree(params, psh)
        b = make_batch(cfg, SHAPE["seq"], SHAPE["batch"], step=5)
        with torch.no_grad():
            want = model.logits_fn(params, b)
        got = pre(local_p, b)
        out["prefill"], out["prefill_u"] = got.numpy(), want.numpy()
        out["prefill_bitwise"] = np.array(torch.equal(got, want))
        seq = 24
        serve, _, cache_abs, _ = sb.make_sharded_serve_step(
            model, ShapeConfig("d", seq, SHAPE["batch"], "decode"))
        cache_sh = shd.safe_sharding_tree(cache_abs, model.cache_logical())
        cache = sb.shard_tree(model.init_cache(SHAPE["batch"], seq,
                                               device="cpu"), cache_sh)
        ucache = model.init_cache(SHAPE["batch"], seq, device="cpu")
        toks = b["tokens"]
        bitwise = True
        for pos in range(4):
            db = {"tokens": toks[:, pos:pos + 1].contiguous(),
                  "pos": torch.tensor(pos, dtype=torch.int32)}
            lg, cache = serve(local_p, cache, db)
            with torch.no_grad():
                ul, ucache = model.decode_step(params, ucache, db, seq)
            out[f"serve{pos}"], out[f"serve_u{pos}"] = lg.numpy(), ul.numpy()
            bitwise = bitwise and torch.equal(lg, ul)
        whole_cache = sb.gather_tree(cache, cache_sh)
        bitwise = bitwise and same(whole_cache, ucache)
        out["serve_bitwise"] = np.array(bitwise)
        out["cache_err"] = np.array(max(
            float((a - c).abs().max()) for a, c in zip(
                tree_leaves(whole_cache), tree_leaves(ucache))))
    # gradient accumulation (2 micro-batches): each rank's micro-batch i
    # is its part of global micro-batch i, the batch split over data x
    # model by qwen2's training rules
    amodel = build_model(cfg.replace(grad_accum=2))
    with shd.use_mesh(mesh, cfg.rules("train")):
        step, _, _ = sb.make_sharded_train_step(amodel, shape, mode="dense")
        st_sh = sb.state_shardings(amodel, mode="dense", error_feedback=False)
    state0 = init_state(amodel, mode="dense", device="cpu", params=params)
    local, ref = sb.shard_tree(state0, st_sh), state0
    ref_step = make_train_step(amodel, mode="dense")
    for s, b in enumerate(batches):
        local, met, _ = step(local, b)
        ref, rmet, _ = ref_step(ref, b)
        out[f"accum_loss{s}"] = met["loss"].numpy()
        out[f"accum_uloss{s}"] = rmet["loss"].numpy()
    whole = sb.gather_tree(local, st_sh)
    for i, (l, r) in enumerate(zip(tree_leaves(whole["params"]),
                                   tree_leaves(ref["params"]))):
        out[f"accum_p{i}"], out[f"accum_up{i}"] = l.numpy(), r.numpy()
    out["accum_bitwise"] = np.array(same(whole, ref))
    # the other cache trees: Mamba state, mLSTM/sLSTM states, cross K/V
    for arch in FAMILIES:
        fcfg = get_config(arch).reduced()
        fmodel = build_model(fcfg)
        fparams = fmodel.init(0, device="cpu")
        with shd.use_mesh(mesh, fcfg.rules("decode")):
            fpsh = sb.param_shardings(fmodel)
            serve, _, cache_abs, _ = sb.make_sharded_serve_step(
                fmodel, ShapeConfig("d", seq, SHAPE["batch"], "decode"))
            cache_sh = shd.safe_sharding_tree(cache_abs,
                                              fmodel.cache_logical())
            cache = sb.shard_tree(fmodel.init_cache(SHAPE["batch"], seq,
                                                    device="cpu"), cache_sh)
            local_f = sb.shard_tree(fparams, fpsh)
        ucache = fmodel.init_cache(SHAPE["batch"], seq, device="cpu")
        fb = make_batch(fcfg, seq, SHAPE["batch"], kind="decode", step=3)
        err = 0.0
        for pos in range(3):
            db = dict(fb, pos=torch.tensor(pos, dtype=torch.int32))
            lg, cache = serve(local_f, cache, db)
            with torch.no_grad():
                ul, ucache = fmodel.decode_step(fparams, ucache, db, seq)
            err = max(err, float((lg - ul).abs().max())
                      / max(float(ul.abs().max()), 1.0))
        whole_cache = sb.gather_tree(cache, cache_sh)
        for a, c in zip(tree_leaves(whole_cache), tree_leaves(ucache)):
            err = max(err, float((a - c).abs().max()))
        out[f"{arch}_serve_err"] = np.array(err)
        out[f"{arch}_cache_leaves"] = np.array(len(tree_leaves(ucache)))
    if rank == 0:
        np.savez(sys.argv[-1], **out)
    dist.barrier()
    dist.destroy_process_group()
""")


def _launch(args, env):
    return subprocess.Popen([sys.executable, "-c"] + args, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    tmp = tmp_path_factory.mktemp("sharded_step")
    model = build_model(get_config("qwen2-1.5b").reduced())
    rng = np.random.default_rng(0)
    inp = {}
    for i, p in enumerate(tree_leaves(model.init(0, device="cpu"))):
        inp[f"p{i}"] = p.numpy()
        inp[f"g{i}"] = rng.standard_normal(p.shape).astype(np.float32)
    src = str(tmp / "inp.npz")
    np.savez(src, **inp)
    # gloo's pairs on the loopback interface: the ranks never leave
    # the host
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [_launch([JAX_SCRIPT, src, str(tmp / "jax.npz")], env)]
    procs += [_launch([PORT_SCRIPT, str(r), "4", str(tmp / "store4"), src,
                       str(tmp / "port4.npz")], env) for r in range(4)]
    procs += [_launch([PORT_SCRIPT, "0", "1", str(tmp / "store1"), src,
                       str(tmp / "port1.npz")], env)]
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    return {k: dict(np.load(tmp / f"{k}.npz"))
            for k in ("jax", "port4", "port1")}


def _leaves(d, prefix):
    n = sum(1 for k in d if k.startswith(prefix)
            and k[len(prefix):].isdigit())
    return [d[f"{prefix}{i}"] for i in range(n)]


@pytest.mark.parametrize("rules", RULES)
def test_compress_sharded_bitwise_equals_the_reference(runs, rules):
    jax, port = runs["jax"], runs["port4"]
    for kind in ("cv", "ci"):
        want = _leaves(jax, f"{rules}_{kind}")
        got = _leaves(port, f"{rules}_{kind}")
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rules", RULES)
def test_abstract_compress_gives_the_live_rows(runs, rules):
    """The same compression rank by rank in this process (abstract mesh),
    on the fixture's gradient bytes (drawn again from its seed)."""
    from repro_torch import tree_leaves, tree_map
    from repro_torch.compression.sparse import SparseGrad
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import step_builder as sb
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    cfg = get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    grads = tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(p.shape).astype(np.float32)),
        model.abstract_params())
    with shd.use_mesh(make_local_mesh(2, 2),
                      cfg.rules("train") if rules == "train" else {}):
        psh = sb.param_shardings(model)
        pspecs = tree_map(lambda s: s.spec, psh,
                          is_leaf=lambda x: isinstance(x, shd.NamedSharding))
        cg = sb.compress_sharded(grads, pspecs, shd.current().mesh, 0.01)
    got = tree_leaves(cg, is_leaf=lambda x: isinstance(x, SparseGrad))
    for i, sg in enumerate(got):
        assert sg.values.numpy().tobytes() == \
            runs["jax"][f"{rules}_cv{i}"].tobytes()
        assert sg.indices.numpy().tobytes() == \
            runs["jax"][f"{rules}_ci{i}"].tobytes()


def _close(got, want):
    d = np.abs(got - want)
    return float(d.max()), float(np.mean(d <= CLOSE))


@pytest.mark.parametrize("mode", MODES)
def test_sharded_steps_match_the_reference_and_unsharded(runs, mode):
    jax, port = runs["jax"], runs["port4"]
    for s in range(2):
        assert abs(float(port[f"{mode}_loss{s}"])
                   - float(jax[f"{mode}_loss{s}"])) < LOSS_TOL
        assert abs(float(port[f"{mode}_loss{s}"])
                   - float(port[f"{mode}_uloss{s}"])) < LOSS_TOL
    for k in ("p", "mu", "nu"):
        got = _leaves(port, f"{mode}_{k}")
        for want in (_leaves(jax, f"{mode}_{k}"),
                     _leaves(port, f"{mode}_u{k}")):
            assert len(got) == len(want) > 0
            worst, share = _close(np.concatenate([g.ravel() for g in got]),
                                  np.concatenate([w.ravel() for w in want]))
            assert worst <= STATE_TOL and share >= CLOSE_SHARE, (k, worst,
                                                                 share)
    if mode == "lowdiff_sharded":
        got = np.concatenate([g.ravel() for g in _leaves(port, f"{mode}_ci")])
        for want in (_leaves(jax, f"{mode}_ci"),):
            want = np.concatenate([w.ravel() for w in want])
            assert got.shape == want.shape
            assert np.mean(got == want) >= CLOSE_SHARE


def test_world_of_one_is_bitwise_unsharded(runs):
    one = runs["port1"]
    for mode in MODES + ("lowdiff",):
        assert bool(one[f"{mode}_state_bitwise"]), mode
        for s in range(2):
            assert one[f"{mode}_loss{s}"].tobytes() == \
                one[f"{mode}_uloss{s}"].tobytes()
    assert bool(one["lowdiff_sharded_cg_bitwise"])
    assert bool(one["lowdiff_cg_bitwise"])
    assert bool(one["prefill_bitwise"]) and bool(one["serve_bitwise"])


def test_prefill_and_serve_match_unsharded(runs):
    port = runs["port4"]
    scale = np.abs(port["prefill_u"]).max()
    assert np.abs(port["prefill"] - port["prefill_u"]).max() <= \
        LOGIT_TOL * max(scale, 1.0)
    for pos in range(4):
        got, want = port[f"serve{pos}"], port[f"serve_u{pos}"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= \
            LOGIT_TOL * max(np.abs(want).max(), 1.0)
    assert float(port["cache_err"]) <= LOGIT_TOL


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_step_takes_every_cache_tree(runs, arch):
    """Hymba's Mamba state, xLSTM's mLSTM/sLSTM states and Seamless's
    cross K/V through the sharded serve step on (2, 2): logits (scaled)
    and every cache leaf within ``LOGIT_TOL`` of ``decode_step``."""
    port = runs["port4"]
    assert int(port[f"{arch}_cache_leaves"]) >= 4
    assert float(port[f"{arch}_serve_err"]) <= LOGIT_TOL
    assert float(runs["port1"][f"{arch}_serve_err"]) == 0.0


def test_lowdiff_passes_through_as_the_unsharded_step(runs):
    """``lowdiff`` (error feedback, the global leaf compressed) on 4
    ranks against the unsharded lowdiff step: state and residual within
    the state tolerance, >= 99.9% of the picks equal."""
    port = runs["port4"]
    for s in range(2):
        assert abs(float(port[f"lowdiff_loss{s}"])
                   - float(port[f"lowdiff_uloss{s}"])) < LOSS_TOL
    for k in ("p", "mu", "nu", "ef"):
        got, want = _leaves(port, f"lowdiff_{k}"), _leaves(port,
                                                             f"lowdiff_u{k}")
        assert len(got) == len(want) > 0
        worst, share = _close(np.concatenate([g.ravel() for g in got]),
                              np.concatenate([w.ravel() for w in want]))
        assert worst <= STATE_TOL and share >= CLOSE_SHARE, (k, worst, share)
    got = np.concatenate([g.ravel() for g in _leaves(port, "lowdiff_ci")])
    want = np.concatenate([w.ravel() for w in _leaves(port, "lowdiff_u_ci")])
    assert got.shape == want.shape and np.mean(got == want) >= CLOSE_SHARE


def test_gradient_accumulation_splits_each_micro_batch(runs):
    """``grad_accum`` 2 with the batch over data x model: each rank
    computes its part of every micro-batch; the sum equals the unsharded
    accumulated step within the state tolerance, bitwise on one rank."""
    port = runs["port4"]
    for s in range(2):
        assert abs(float(port[f"accum_loss{s}"])
                   - float(port[f"accum_uloss{s}"])) < LOSS_TOL
    worst, share = _close(
        np.concatenate([g.ravel() for g in _leaves(port, "accum_p")]),
        np.concatenate([w.ravel() for w in _leaves(port, "accum_up")]))
    assert worst <= STATE_TOL and share >= CLOSE_SHARE
    assert bool(runs["port1"]["accum_bitwise"])
