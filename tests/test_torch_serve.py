"""The port's serving entry point (``repro_torch.launch.serve``) against the
reference's on the CPU: its flags, ``load_params`` from stores written
by either package (a LowDiff top-k chain's newest full, a LowDiff+ chain
with patches) bit for bit, the greedy tokens of ``serve.run`` on the
same checkpoint directory, the refusal to run without a card unless the
CPU is asked for, and the three ``examples/torch_*.py`` at their quick
sizes.

Tolerance: reduced configs run in f32, where the two packages' logits
agree to ~1e-5; a greedy token must agree wherever the reference's
top-2 margin exceeds ``MARGIN`` = 1e-4, and may differ (with all later
tokens of that request) only past a step whose margin is below it."""
import argparse
import os
import runpy
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.config import StoreConfig as JaxStoreConfig
from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.configs import get_config as jax_config
from repro.core.lowdiff import LowDiff as JaxLowDiff
from repro.core.lowdiff_plus import LowDiffPlus as JaxLowDiffPlus
from repro.core.steps import init_state as jax_init_state
from repro.data.synthetic import make_batch as jax_batch
from repro.launch import serve as jax_serve
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.checkpoint.config import StoreConfig
from repro_torch.configs import get_config
from repro_torch.core.lowdiff import LowDiff
from repro_torch.core.steps import init_state
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import serve
from repro_torch.models.registry import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-1.5b"
MARGIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (six workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch):
    """The parser the reference's ``serve.main`` builds (it has no
    ``build_parser``): caught at ``parse_args``."""
    def grab(self, *a, **k):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        jax_serve.main()
    monkeypatch.undo()
    return e.value.args[0]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_flags_are_the_references_plus_device(monkeypatch):
    mine = _actions(serve.build_parser())
    ref = _actions(_reference_parser(monkeypatch))
    assert set(mine) == set(ref) | {"device"}
    for dest, a in ref.items():
        b = mine[dest]
        assert (b.option_strings, b.default, b.type, b.choices,
                b.const, b.nargs) == (a.option_strings, a.default, a.type,
                                      a.choices, a.const, a.nargs), dest
    # the reference's quirk, kept: --reduced is on whatever is passed
    assert serve.build_parser().parse_args([]).reduced is True
    assert mine["device"].default == "cuda"


# ------------------------------------------------------------- stores
def _reference_lowdiff_store(root, steps=6):
    """A reference LowDiff (top-k) run on reduced qwen2: a full at step
    4 and differentials after it."""
    jcfg = jax_config(ARCH).reduced()
    jm = jax_model(jcfg)
    strat = JaxLowDiff(jm, JaxStoreConfig(root=root).build(),
                       full_interval=4, batch_size=2,
                       parallel_recovery=False)
    state = jax_init_state(jm, jax.random.PRNGKey(4))
    for t in range(steps):
        state, _ = strat.train_step(state, jax_batch(jcfg, 32, 2, step=t))
    strat.close()
    return jm


def _reference_lowdiff_plus_store(root):
    jcfg = jax_config(ARCH).reduced()
    jm = jax_model(jcfg)
    state = jax_init_state(jm, jax.random.PRNGKey(5), mode="lowdiff_plus")
    strat = JaxLowDiffPlus(jm, JaxStore(root), persist_interval=1,
                           persist_mode="incremental",
                           dirty_granularity="row", diff_quant="int4",
                           queue_size=2)
    for t in range(3):
        state, _ = strat.train_step(state, jax_batch(jcfg, 32, 2, step=t))
    strat.flush()
    strat.close()
    return jm


def _port_lowdiff_store(root, steps=6):
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    strat = LowDiff(model, StoreConfig(root=root).build(), full_interval=4,
                    batch_size=2, device="cpu")
    state = init_state(model, 3, device="cpu")
    for t in range(steps):
        state, _ = strat.train_step(state, make_batch(cfg, 32, 2, step=t))
    strat.close()
    return model, state


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _assert_bitwise(mine, ref):
    a, b = _flat(mine), _flat(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        x = a[k].view(torch.int16).numpy() if a[k].dtype == torch.bfloat16 \
            else a[k].numpy()
        y = np.asarray(b[k])
        y = y.view(np.int16) if y.dtype.name == "bfloat16" else y
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        assert x.tobytes() == y.tobytes(), k


def test_load_params_of_a_reference_lowdiff_store(tmp_path):
    """A top-k chain: both packages load its newest full (step 4), not
    the chain's last step, bit for bit alike."""
    root = str(tmp_path)
    jm = _reference_lowdiff_store(root)
    mine = serve.load_params(build_model(get_config(ARCH).reduced()), root,
                             device="cpu")
    ref = jax_serve.load_params(jm, root)
    _assert_bitwise(mine, ref)
    assert all(t.device.type == "cpu" for t in tree_leaves(mine))
    assert sorted(mine) == sorted(jm.init(jax.random.PRNGKey(0)))


def test_load_params_of_a_reference_lowdiff_plus_chain(tmp_path):
    """A LowDiff+ chain (a full, then int4 row patches): the patches are
    overlaid, and the params come back under the replica's flat path
    names in both packages (neither ``run`` can serve those)."""
    root = str(tmp_path)
    jm = _reference_lowdiff_plus_store(root)
    store = JaxStore(root)
    assert store.manifest["patches"]
    store.close()
    mine = serve.load_params(build_model(get_config(ARCH).reduced()), root,
                             device="cpu")
    ref = jax_serve.load_params(jm, root)
    _assert_bitwise(mine, ref)
    assert "['embed']" in mine
    kw = dict(arch=ARCH, reduced=True, batch=1, prompt_len=2, gen=1,
              ckpt_dir=root, log_level="warning")
    with pytest.raises(KeyError):
        jax_serve.run(argparse.Namespace(**kw))
    with pytest.raises(KeyError):
        serve.run(argparse.Namespace(device="cpu", **kw))


def test_port_store_loads_in_the_reference(tmp_path):
    """A port-written top-k chain (full at step 4, then steps 5-6): both
    packages serve the full's params, not the live step-6 params."""
    root = str(tmp_path)
    model, state = _port_lowdiff_store(root)
    mine = serve.load_params(model, root, device="cpu")
    ref = jax_serve.load_params(jax_model(jax_config(ARCH).reduced()), root)
    _assert_bitwise(mine, ref)
    assert int(state["step"]) == 6
    assert not torch.equal(mine["embed"], state["params"]["embed"])


def test_load_params_of_an_empty_directory_is_none(tmp_path):
    model = build_model(get_config(ARCH).reduced())
    assert serve.load_params(model, str(tmp_path), device="cpu") is None


# ---------------------------------------------------------------- run
def _reference_generate(jm, params, prompt, gen):
    """The reference's decode loop (``serve.run``), keeping its logits."""
    B, P = prompt.shape
    total = P + gen
    cache = jm.init_cache(B, total)
    step = jax.jit(lambda p, c, b: jm.decode_step(p, c, b, total))
    tokens = jnp.asarray(prompt[:, :1], jnp.int32)
    out, logits_seen = [], []
    for pos in range(total - 1):
        logits, cache = step(params, cache, {"tokens": tokens,
                                             "pos": jnp.asarray(pos,
                                                                jnp.int32)})
        logits_seen.append(np.asarray(logits))
        if pos + 1 < P:
            tokens = jnp.asarray(prompt[:, pos + 1:pos + 2], jnp.int32)
        else:
            tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
            out.append(np.asarray(tokens[:, 0]))
    return out, logits_seen


def test_run_gives_the_references_tokens(tmp_path):
    """Both ``serve.run`` on one checkpoint directory: every logit within
    1e-4 of the reference's at each step of the prompt (the same inputs)
    and the same greedy tokens while the reference's margins clear
    ``MARGIN``."""
    root = str(tmp_path)
    jm = _reference_lowdiff_store(root)
    kw = dict(arch=ARCH, reduced=True, batch=4, prompt_len=8, gen=12,
              ckpt_dir=root, log_level="warning")
    ref_tokens = jax_serve.run(argparse.Namespace(**kw))
    tokens, logits = serve.run(argparse.Namespace(device="cpu", **kw),
                               return_logits=True)
    prompt = np.random.default_rng(0).integers(
        0, jm.cfg.vocab, (kw["batch"], kw["prompt_len"]))
    want, ref_logits = _reference_generate(
        jm, jax_serve.load_params(jm, root), prompt, kw["gen"])
    np.testing.assert_array_equal(np.stack(want), np.stack(ref_tokens))
    assert len(tokens) == kw["gen"] and len(logits) == len(ref_logits)
    assert all(t.dtype == np.int32 and t.shape == (4,) for t in tokens)
    for a, b in zip(logits[:kw["prompt_len"]], ref_logits):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
    P = kw["prompt_len"]
    for r in range(kw["batch"]):
        for g in range(kw["gen"]):
            top2 = np.sort(ref_logits[P - 1 + g][r])[-2:]
            if top2[1] - top2[0] < MARGIN:
                break                       # a near-tie: may diverge
            assert tokens[g][r] == ref_tokens[g][r], (r, g)


def test_run_without_a_checkpoint_uses_a_seeded_init(tmp_path):
    """No loadable full: a seeded init, the same tokens twice."""
    kw = dict(arch=ARCH, reduced=True, batch=2, prompt_len=3, gen=4,
              ckpt_dir=str(tmp_path), device="cpu", log_level="warning")
    a = serve.run(argparse.Namespace(**kw))
    b = serve.run(argparse.Namespace(**kw))
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
    assert all(((t >= 0) & (t < 512)).all() for t in a)


def test_serve_without_a_card_or_cpu_flag_raises(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--gen", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "tok/s" not in out.stdout + out.stderr


# ------------------------------------------------------------ examples
def _example(name):
    return runpy.run_path(os.path.join(REPO, "examples", name),
                          run_name="example")


def test_example_serve_batched(capsys):
    _example("torch_serve_batched.py")["main"](["--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("OK")


def test_example_quickstart(tmp_path, capsys):
    _example("torch_quickstart.py")["main"](
        ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    assert "OK — recovery is exact." in capsys.readouterr().out


def test_example_train_with_failures(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)   # re-read TMPDIR
    losses = _example("torch_train_with_failures.py")["main"](
        ["--quick", "--device", "cpu"])
    assert len(losses) == 40
    assert os.path.isdir(tmp_path / "repro_torch_e2e")
    assert "across an injected failure" in capsys.readouterr().out
