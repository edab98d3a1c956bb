"""The port's expert-parallel MoE (``moe._moe_apply_ep`` on
``torch.distributed``) against its dense dispatch and the reference's
``shard_map`` path: the twin of ``tests/test_moe_ep.py``.

Reduced DeepSeekMoE (4 experts, top-2, one shared expert), layer 0's
params, x of (8, S, d). The reference runs in a subprocess on 4 fake
CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``);
the port runs 4 gloo ranks in subprocesses on a (data 2, model 2) mesh,
initialised through a ``FileStore``. Both start from the same numpy
params and inputs. S = 16 takes the sequence-sharded branch (all-gather
before routing, reduce-scatter after), S = 15 the all-reduce branch.

Tolerance: output and every parameter gradient (and the input's)
within 1e-5 of the port's dense dispatch and of the reference's EP
(the reference's own test's bound; f32, sums reassociated across
ranks: ~3e-7 seen).

A whole sharded ``dense`` step of reduced DeepSeekMoE on the same
(2, 2) mesh runs the EP path inside the model (the dispatch takes it),
with the reference's data-shard semantics of ``aux`` (the mean of each
data shard's), and is held to the reference's sharded step: the loss
within 1e-5, every parameter within 2 lr after two steps (Adam near eps,
as in ``test_torch_sharded_step.py``) and >= 99.9% within 1e-5."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TOL = 1e-5
NAMES = ("router", "we_d", "we_g", "we_u", "ws_d", "ws_g", "ws_u")
SEQS = (16, 15)

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.models import moe as moe_lib
    from repro.launch.mesh import make_local_mesh
    from repro.distributed import sharding as shd
    from repro.configs.base import ShapeConfig
    from repro.data.synthetic import make_batch
    from repro.distributed import step_builder as sb
    from repro.models.registry import build_model
    from repro.optim.adam import adam_init
    inp = np.load(sys.argv[1])
    cfg = get_config("deepseek-moe-16b").reduced()
    lp = {k: jnp.asarray(inp[k]) for k in %r}
    out = {}
    mesh = make_local_mesh(2, 2)
    model = build_model(cfg)
    td = jax.tree.structure(model.abstract_params())
    params = td.unflatten([jnp.asarray(inp[f"p{i}"])
                           for i in range(td.num_leaves)])
    with shd.use_mesh(mesh, cfg.rules("train")):
        step, _, _ = sb.make_sharded_train_step(
            model, ShapeConfig("t", 16, 8, "train"), mode="dense",
            donate=False)
        st = jax.device_put({"params": params, "opt": adam_init(params),
                             "step": jnp.zeros((), jnp.int32)},
                            sb.state_shardings(model, mode="dense",
                                               error_feedback=False))
        for i in range(2):
            st, met, _ = step(st, make_batch(cfg, 16, 8, step=i))
            out[f"step_loss{i}"] = np.asarray(met["loss"])
    for i, l in enumerate(jax.tree.leaves(st["params"])):
        out[f"step_p{i}"] = np.asarray(l)
    for S in %r:
        x = jnp.asarray(inp[f"x{S}"])
        f = lambda p, x: moe_lib._moe_apply_ep(p, x, cfg, shd.current(), 2)
        with shd.use_mesh(mesh):
            y, _ = jax.jit(f)(lp, x)
            gp, gx = jax.jit(jax.grad(lambda p, x: f(p, x)[0].sum(),
                                      argnums=(0, 1)))(lp, x)
        out[f"y{S}"] = np.asarray(y)
        out[f"gx{S}"] = np.asarray(gx)
        for k in gp:
            out[f"g{S}_{k}"] = np.asarray(gp[k])
    np.savez(sys.argv[2], **out)
""" % (NAMES, SEQS))

PORT_SCRIPT = textwrap.dedent("""
    import sys
    rank, world, store, inp_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    inp = np.load(inp_path)
    cfg = get_config("deepseek-moe-16b").reduced()
    mesh = make_local_mesh(2, 2)
    assert shd.is_live(mesh)
    out = {}
    with shd.use_mesh(mesh) as ctx:
        me = shd.coordinate(mesh)
        dg = shd.axis_group(mesh, ("data",))
        for S in %r:
            x = torch.from_numpy(inp[f"x{S}"])
            B = x.shape[0] // 2
            xd = x[me["data"] * B:(me["data"] + 1) * B].clone()
            xd.requires_grad_(True)
            lp = {k: torch.from_numpy(inp[k]).requires_grad_(True)
                  for k in %r}
            tokens = x.shape[0] * x.shape[1]
            assert tokens >= 16 * cfg.moe.n_experts
            y, aux = moe._moe_apply_ep(lp, xd, cfg, ctx, 2)
            y.sum().backward()
            ys = [torch.empty_like(y) for _ in range(2)]
            gxs = [torch.empty_like(y) for _ in range(2)]
            dist.all_gather(ys, y.detach().contiguous(), group=dg)
            dist.all_gather(gxs, xd.grad.contiguous(), group=dg)
            out[f"y{S}"] = torch.cat(ys).numpy()
            out[f"gx{S}"] = torch.cat(gxs).numpy()
            for k, v in lp.items():
                g = v.grad.clone()
                dist.all_reduce(g, group=dg)
                out[f"g{S}_{k}"] = g.numpy()
            out[f"aux{S}"] = aux.detach().numpy()
            # the dispatch takes the EP path under the live mesh
            seen = []
            real = moe._moe_apply_ep
            moe._moe_apply_ep = lambda *a: seen.append(1) or real(*a)
            try:
                moe.moe_apply(lp, xd.detach(), cfg)
            finally:
                moe._moe_apply_ep = real
            out[f"dispatch{S}"] = np.array(len(seen))
    # a sharded dense step with EP inside the model
    from repro_torch import tree_leaves, tree_map
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.steps import init_state
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed import step_builder as sb
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    it = iter(range(10 ** 6))
    params = tree_map(lambda _: torch.from_numpy(inp[f"p{next(it)}"]),
                      model.abstract_params())
    calls = []
    real = moe._moe_apply_ep
    moe._moe_apply_ep = lambda *a: calls.append(1) or real(*a)
    with shd.use_mesh(mesh, cfg.rules("train")):
        step, _, _ = sb.make_sharded_train_step(
            model, ShapeConfig("t", 16, 8, "train"), mode="dense")
        st_sh = sb.state_shardings(model, mode="dense", error_feedback=False)
    local = sb.shard_tree(init_state(model, mode="dense", device="cpu",
                                     params=params), st_sh)
    for i in range(2):
        local, met, _ = step(local, make_batch(cfg, 16, 8, step=i))
        out[f"step_loss{i}"] = met["loss"].numpy()
    moe._moe_apply_ep = real
    out["step_ep_calls"] = np.array(len(calls))
    for i, l in enumerate(tree_leaves(sb.gather_tree(local, st_sh)["params"])):
        out[f"step_p{i}"] = l.numpy()
    if rank == 0:
        # the dense dispatch on the whole batch, and no mesh -> dense
        for S in %r:
            x = torch.from_numpy(inp[f"x{S}"]).requires_grad_(True)
            lp = {k: torch.from_numpy(inp[k]).requires_grad_(True)
                  for k in %r}
            y, aux = moe._moe_apply_dense(lp, x, cfg)
            y.sum().backward()
            out[f"dense_y{S}"] = y.detach().numpy()
            out[f"dense_gx{S}"] = x.grad.numpy()
            for k, v in lp.items():
                out[f"dense_g{S}_{k}"] = v.grad.numpy()
    np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()
""" % (SEQS, NAMES, SEQS, NAMES))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    tmp = tmp_path_factory.mktemp("moe_ep")
    cfg = get_config("deepseek-moe-16b").reduced()
    params = build_model(cfg).init(0, device="cpu")
    rng = np.random.default_rng(0)
    inp = {k: params["layers"]["moe"][k][0].numpy() for k in NAMES}
    from repro_torch import tree_leaves
    for i, p in enumerate(tree_leaves(params)):
        inp[f"p{i}"] = p.numpy()
    for S in SEQS:
        inp[f"x{S}"] = (rng.normal(size=(8, S, cfg.d_model)) * 0.1
                        ).astype(np.float32)
    np.savez(tmp / "inp.npz", **inp)
    # gloo's pairs on the loopback interface: the ranks never leave
    # the host
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "inp.npz"),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", PORT_SCRIPT, str(r), "4", str(tmp / "store"),
         str(tmp / "inp.npz"), str(tmp / f"port{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return (np.load(tmp / "jax.npz"),
            [np.load(tmp / f"port{r}.npz") for r in range(4)])


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("S", SEQS)
def test_ep_output_matches_dense_and_reference(runs, S):
    ref, ports = runs
    port = ports[0]
    for p in ports[1:]:            # every rank returns the same result
        np.testing.assert_array_equal(p[f"y{S}"], port[f"y{S}"])
    assert _err(port[f"y{S}"], port[f"dense_y{S}"]) < TOL
    assert _err(port[f"y{S}"], ref[f"y{S}"]) < TOL


@pytest.mark.parametrize("S", SEQS)
def test_ep_gradients_match_dense_and_reference(runs, S):
    ref, ports = runs
    port = ports[0]
    assert _err(port[f"gx{S}"], port[f"dense_gx{S}"]) < TOL
    assert _err(port[f"gx{S}"], ref[f"gx{S}"]) < TOL
    for k in NAMES:
        for p in ports:            # every rank holds the whole gradient
            assert _err(p[f"g{S}_{k}"], port[f"dense_g{S}_{k}"]) < TOL, k
        assert _err(port[f"g{S}_{k}"], ref[f"g{S}_{k}"]) < TOL, k
        assert np.abs(port[f"g{S}_{k}"]).max() > 0, k


@pytest.mark.parametrize("S", SEQS)
def test_dispatch_takes_ep_on_a_live_mesh(runs, S):
    _, ports = runs
    assert all(int(p[f"dispatch{S}"]) == 1 for p in ports)
    auxes = {float(p[f"aux{S}"]) for p in ports}
    assert len(auxes) == 1         # averaged over the data axis


def test_dense_without_a_live_mesh():
    """No mesh, or an abstract one: the dense dispatch."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    cfg = get_config("deepseek-moe-16b").reduced()
    lp = {k: v[0] for k, v in build_model(cfg).init(0, device="cpu")[
        "layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 16, cfg.d_model)).astype(np.float32))
    want, _ = moe._moe_apply_dense(lp, x, cfg)
    with shd.use_mesh(make_local_mesh(2, 2)):
        got, _ = moe.moe_apply(lp, x, cfg)
    assert torch.equal(got, want)


def test_sharded_step_with_ep_matches_the_reference(runs):
    ref, ports = runs
    port = ports[0]
    # two steps x two MoE layers: the EP path ran inside the model
    assert all(int(p["step_ep_calls"]) >= 4 for p in ports)
    for i in range(2):
        assert abs(float(port[f"step_loss{i}"])
                   - float(ref[f"step_loss{i}"])) < TOL
    n = sum(1 for k in ref if k.startswith("step_p"))
    assert n > 0
    d = np.concatenate([np.abs(port[f"step_p{i}"] - ref[f"step_p{i}"]).ravel()
                        for i in range(n)])
    assert d.max() <= 2 * 1e-3 and np.mean(d <= TOL) >= 0.999
