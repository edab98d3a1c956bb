"""The other model families through the port's LowDiff, against the JAX
reference on the CPU at reduced size: one whole LowDiff step per family;
LowDiff chains of reduced DeepSeekMoE (4-D expert leaves) and reduced
Seamless written by either package and recovered in the other; a
LowDiff+ row-granular chain of reduced DeepSeekMoE loaded bitwise by
both; the training CLI on every family, failure and recovery included."""
import io
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.config import StoreConfig as JaxStoreConfig
from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.configs import get_config as jax_config
from repro.core import recovery as jrec
from repro.core.lowdiff import LowDiff as JaxLowDiff
from repro.core.lowdiff_plus import LowDiffPlus as JaxLowDiffPlus
from repro.core.steps import init_state as jax_init_state
from repro.core.steps import make_train_step as jax_make_step
from repro.data.synthetic import make_batch as jax_batch
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.checkpoint.config import StoreConfig
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.core import recovery as rec
from repro_torch.core.lowdiff import LowDiff
from repro_torch.core.lowdiff_plus import LowDiffPlus
from repro_torch.core.steps import init_state, make_train_step
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.train import main as train_main
from repro_torch.models.param import from_jax_params
from repro_torch.models.registry import build_model
from repro_torch.obs import log as obs_log

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
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _corrected(ef, cg):
    """The EF-corrected gradients a lowdiff step compressed, rebuilt from
    its outputs (``test_torch_grad_accum``): the new residual is zero at
    the picks, so adding the picks back gives ``corrected``."""
    out = []
    for e, (vals, idx) in zip(ef, zip(cg[0::2], cg[1::2])):
        flat = np.zeros(vals.shape[0] * 1024, np.float32)
        flat[:e.size] = e.reshape(-1)
        rows = flat.reshape(vals.shape[0], 1024)
        np.put_along_axis(rows, idx, np.take_along_axis(rows, idx, 1)
                          + vals, 1)
        out.append(rows)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_whole_lowdiff_step_matches_reference(arch):
    """One lowdiff step (top-k + error feedback) from the same params and
    batch, on the reduced config with its own ``grad_accum`` (and, for
    Qwen3-MoE, its bf16 accumulator) restored, with
    ``test_torch_step``'s tolerances: loss within 2e-6 relative, top-k
    rows equal in >= 99.9% of the blocks, every block whose corrected
    gradient is the same in both packages picking the same rows, and on
    the blocks that agree every weight within one step (lr) of the
    reference's and all but 1e-4 of them within 2e-5. A first Adam step
    moves a weight by lr*g/(|g|+eps), so a gradient near eps amplifies
    rounding differences (the dense step's rule in ``test_torch_step``):
    xLSTM's input-gate bias has such gradients, since a shift common to
    all input gates cancels in the normalized mLSTM output (4 weights
    of the reduced model)."""
    full = get_config(arch)
    kw = dict(grad_accum=full.grad_accum)
    jm = jax_model(jax_config(arch).reduced().replace(**kw))
    m = build_model(get_config(arch).reduced().replace(**kw))
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
    agree = total = far = compared = 0
    for (a, b), s, j, same in zip(
            zip(tree_leaves(new["params"]), jax.tree.leaves(jnew["params"])),
            mine[1::2], ref[1::2], same_grad):
        rows = (s == j).all(axis=1)
        assert rows[same].all()
        agree += int(rows.sum())
        total += rows.size
        mask = np.repeat(rows, 1024)[:a.numel()]
        d = np.abs(a.numpy().reshape(-1)[mask]
                   - np.asarray(b).reshape(-1)[mask])
        assert d.max(initial=0.0) <= 1e-3
        far += int((d > 2e-5).sum())
        compared += d.size
    assert agree >= 0.999 * total, (agree, total)
    assert far <= 1e-4 * compared, (far, compared)


# ---------------------------------------------------------------- chains
def _assert_state_close(params, opt, ref_params, ref_opt):
    """``test_torch_checkpoint``'s bounds: the packages round 1-b**count
    and the moment sums an ulp apart per replayed step."""
    for a, b in zip(tree_leaves(params), jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-6)
    for a, b in zip(tree_leaves((opt.mu, opt.nu)),
                    jax.tree.leaves((ref_opt.mu, ref_opt.nu))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-9)
    assert int(opt.count) == int(ref_opt.count)


def _assert_chains_bitwise(d):
    """Both packages load the chain at ``d`` to the same bits."""
    state, diffs = rec.load_latest_chain(StoreConfig.from_dict(d).build())
    jstate, jdiffs = jrec.load_latest_chain(
        JaxStoreConfig.from_dict(d).build())
    assert [s for s, _ in diffs] == [s for s, _ in jdiffs] == [5, 6, 7]
    mine = tree_leaves((state, [p for _, p in diffs]))
    theirs = jax.tree.leaves((jstate, [p for _, p in jdiffs]))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.tobytes() == b.tobytes()


CHAIN_ARCHS = ("deepseek-moe-16b", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", CHAIN_ARCHS)
def test_port_chain_recovers_in_reference(tmp_path, arch):
    """Full at step 4, differentials 5-7, written by the port; the
    reference loads the same bits and its serial replay recovers the
    port's trained state."""
    d = {"root": str(tmp_path), "tiers": [{"kind": "local"}], "fmt": "frame"}
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    strat = LowDiff(model, StoreConfig.from_dict(d).build(),
                    full_interval=4, batch_size=2, device="cpu")
    state = init_state(model, 3, device="cpu")
    for t in range(7):
        state, _ = strat.train_step(state, make_batch(cfg, 64, 2, step=t))
    strat.close()
    _assert_chains_bitwise(d)
    jstate, diffs = jrec.load_latest_chain(
        JaxStoreConfig.from_dict(d).build())
    diffs = jrec.contiguous_prefix(int(jstate["step"]), diffs)
    jp, jopt = jrec.replay_serial(jstate["params"], jstate["opt"], diffs)
    _assert_state_close(state["params"], state["opt"], jp, jopt)
    if arch == "deepseek-moe-16b":
        assert tuple(state["params"]["layers"]["moe"]["we_g"].shape) == \
            (2, 4, 256, 128)


@pytest.mark.parametrize("arch", CHAIN_ARCHS)
def test_reference_chain_recovers_in_port(tmp_path, arch):
    """The same chain written by the reference; the port loads the same
    bits and its serial and device replays recover the reference's
    trained state."""
    d = {"root": str(tmp_path), "tiers": [{"kind": "local"}], "fmt": "frame"}
    jcfg = jax_config(arch).reduced()
    jm = jax_model(jcfg)
    jstrat = JaxLowDiff(jm, JaxStoreConfig.from_dict(d).build(),
                        full_interval=4, batch_size=2,
                        parallel_recovery=False)
    jstate = jax_init_state(jm, jax.random.PRNGKey(4))
    for t in range(7):
        jstate, _ = jstrat.train_step(jstate, jax_batch(jcfg, 64, 2, step=t))
    jstrat.close()
    _assert_chains_bitwise(d)
    state, diffs = rec.load_latest_chain(StoreConfig.from_dict(d).build())
    diffs = rec.contiguous_prefix(int(state["step"]), diffs)
    params, opt = rec.replay_serial(state["params"], state["opt"], diffs,
                                    device="cpu")
    _assert_state_close(params, opt, jstate["params"], jstate["opt"])
    dparams, dopt, applied = rec.replay_device(
        state["params"], state["opt"], diffs, device="cpu")
    assert applied == 3
    for a, b in zip(tree_leaves((params, opt)), tree_leaves((dparams, dopt))):
        assert torch.equal(a, b)


def _assert_state_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_state_bitwise(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                          y.reshape(-1).view(np.uint8))


PLUS = dict(persist_interval=1, persist_mode="incremental",
            dirty_granularity="row", diff_quant="int4", queue_size=2)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_lowdiff_plus_moe_chain_crosses_packages(tmp_path, writer):
    """LowDiff+ (incremental, row-granular, int4 patches) on reduced
    DeepSeekMoE, whose 4-D expert tables are patched row by row: a
    chain written by either package loads to the same bits in both, and
    to the writer's replica within one int4 step."""
    root = str(tmp_path)
    arch = "deepseek-moe-16b"
    if writer == "port":
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        state = init_state(model, 1, mode="lowdiff_plus", device="cpu")
        strat = LowDiffPlus(model, CheckpointStore(root), device="cpu",
                            **PLUS)
        for t in range(3):
            state, _ = strat.train_step(state, make_batch(cfg, 64, 2,
                                                          step=t))
    else:
        jcfg = jax_config(arch).reduced()
        jm = jax_model(jcfg)
        jstate = jax_init_state(jm, jax.random.PRNGKey(5),
                                mode="lowdiff_plus")
        strat = JaxLowDiffPlus(jm, JaxStore(root), **PLUS)
        for t in range(3):
            jstate, _ = strat.train_step(jstate, jax_batch(jcfg, 64, 2,
                                                           step=t))
    try:
        strat.flush()
        patches = strat.store.manifest["patches"]
        assert len(patches) == 2 and all("int4" in e.get("codec", [])
                                         for e in patches)
        replica = strat._replica.params
        assert replica["['layers']['moe']['we_g']"].shape == (2, 4, 256, 128)
    finally:
        strat.close()
    mine, s1 = CheckpointStore(root).load_latest_state()
    theirs, s2 = JaxStore(root).load_latest_state()
    assert s1 == s2 == 3
    _assert_state_bitwise(mine, theirs)
    for k, v in replica.items():
        np.testing.assert_allclose(mine["params"][k], v, rtol=0, atol=0.6)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cli_recovers(tmp_path, arch):
    """``--arch <family> --reduced --device cpu --fail-at``: LowDiff runs,
    fails at step 7, recovers there and runs on to step 8."""
    out = io.StringIO()
    handler = logging.StreamHandler(out)
    root = logging.getLogger(obs_log._ROOT)
    root.addHandler(handler)
    try:
        train_main(["--device", "cpu", "--arch", arch, "--reduced",
                    "--steps", "8", "--full-interval", "4", "--fail-at", "7",
                    "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "4"])
    finally:
        root.removeHandler(handler)
    text = out.getvalue()
    assert f"arch={arch} " in text
    assert "recovered at step 7; resuming" in text, text[-2000:]
    assert "8 steps in" in text
