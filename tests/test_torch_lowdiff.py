"""The port's LowDiff end to end on the CPU (reduced gpt2-l): the
training CLI recovers from an injected failure, serial and device replay
recover the trained params and optimizer state bit for bit, and the
default parallel replay agrees with serial replay and with the JAX
reference's parallel replay up to float reassociation."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.core import recovery as jrec
from repro_torch import tree_leaves
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.core import recovery as rec
from repro_torch.core.lowdiff import LowDiff
from repro_torch.core.steps import init_state
from repro_torch.data.synthetic import make_batch
from repro_torch.models.registry import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return env


def test_train_cli_recovers(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "gpt2-l", "--reduced", "--strategy", "lowdiff",
         "--steps", "8", "--full-interval", "4", "--fail-at", "7",
         "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "4"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "recovered at step 7; resuming" in out.stdout
    assert "8 steps in" in out.stdout


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _train(tmp_path, **kw):
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    strat = LowDiff(model, CheckpointStore(str(tmp_path)), full_interval=4,
                    batch_size=2, device="cpu", **kw)
    state = init_state(model, 1, device="cpu")
    for t in range(7):
        state, _ = strat.train_step(state, make_batch(cfg, 64, 2, step=t))
    strat.flush()
    return strat, state


@pytest.mark.parametrize("replay_device", [False, True])
def test_recovery_is_bitwise_exact(tmp_path, replay_device):
    strat, state = _train(tmp_path, replay_device=replay_device,
                          parallel_recovery=False)
    trained = tree_leaves((state["params"], state["opt"]))
    recovered, applied = strat.recover()
    strat.close()
    assert applied == 3 and int(recovered["step"]) == 7
    got = tree_leaves((recovered["params"], recovered["opt"]))
    assert len(got) == len(trained)
    for a, b in zip(got, trained):
        assert torch.equal(_bits(a), _bits(b))
    assert sorted(recovered) == ["ef", "opt", "params", "step"]


def test_device_replay_equals_serial_replay(tmp_path):
    strat, _ = _train(tmp_path)
    strat.close()
    state, diffs = rec.load_latest_chain(CheckpointStore(str(tmp_path)))
    diffs = rec.contiguous_prefix(int(state["step"]), diffs)
    sp, sopt = rec.replay_serial(state["params"], state["opt"], diffs,
                                 device="cpu")
    for window in (None, 2):
        dp, dopt, n = rec.replay_device(state["params"], state["opt"], diffs,
                                        window=window, device="cpu")
        assert n == len(diffs) == 3
        for a, b in zip(tree_leaves((dp, dopt)), tree_leaves((sp, sopt))):
            assert torch.equal(_bits(a), _bits(b))


def test_device_replay_cuts_at_corrupt_differential(tmp_path):
    strat, _ = _train(tmp_path)
    strat.close()
    state, diffs = rec.load_latest_chain(CheckpointStore(str(tmp_path)))
    bad = dict(diffs[1][1])
    key = sorted(bad)[0]
    sg = bad[key]
    bad[key] = type(sg)(sg.values[:-1], sg.indices[:-1], sg.shape, sg.block)
    diffs = [diffs[0], (diffs[1][0], bad), diffs[2]]
    _, opt, n = rec.replay_device(state["params"], state["opt"], diffs,
                                  device="cpu")
    assert n == 1 and int(opt.count) == int(state["opt"].count) + 1


@pytest.mark.parametrize("where", ["apply", "upload"])
def test_device_replay_raises_on_kernel_or_device_failure(tmp_path,
                                                          monkeypatch, where):
    # a failed launch or upload is not a corrupt differential: recovery
    # must raise, not resume from a silently shortened chain
    from repro_torch.kernels import build
    strat, _ = _train(tmp_path)
    strat.close()
    state, diffs = rec.load_latest_chain(CheckpointStore(str(tmp_path)))

    def launch_fails(*a, **k):
        build.check(700, "topk_apply")      # cudaErrorIllegalAddress

    def upload_fails(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    if where == "apply":
        monkeypatch.setattr(rec.ops, "fused_decode_apply", launch_fails)
    else:
        monkeypatch.setattr(rec, "to_device", upload_fails)
    with pytest.raises(RuntimeError):
        rec.replay_device(state["params"], state["opt"], diffs, device="cpu")


def _assert_replay_close(got, want):
    """Parallel replay sums a window's Adam steps in another order than
    serial replay (and the two packages round moment sums differently):
    the results agree up to that reassociation, a few ulps of the terms."""
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))


def test_parallel_recovery_is_refused(tmp_path):
    """Parallel recovery refuses what it cannot replay: a negative
    window, and a differential whose leaves do not pair with the
    model's."""
    strat, _ = _train(tmp_path)
    strat.close()
    state, diffs = rec.load_latest_chain(CheckpointStore(str(tmp_path)))
    with pytest.raises(ValueError, match="window"):
        rec.replay_parallel(state["params"], state["opt"], diffs, window=-1,
                            device="cpu")
    short = dict(diffs[0][1])
    short.pop(sorted(short)[0])
    with pytest.raises(ValueError, match="leaf count"):
        rec.replay_parallel(state["params"], state["opt"],
                            [(diffs[0][0], short)], device="cpu")


def test_parallel_recovery_is_the_default(tmp_path):
    """Parallel recovery is LowDiff's default, as in the reference, and
    recovers the trained state up to reassociation."""
    strat, state = _train(tmp_path)
    assert strat.parallel_recovery and not strat.replay_device
    recovered, applied = strat.recover()
    strat.close()
    assert applied == 3 and int(recovered["step"]) == 7
    _assert_replay_close(tree_leaves((recovered["params"], recovered["opt"])),
                         tree_leaves((state["params"], state["opt"])))


def test_replay_parallel_chunks_leave_the_result_unchanged(tmp_path,
                                                           monkeypatch):
    """The scan runs on chunks of each flattened leaf so that its scratch
    stays bounded; chunks of one block (ragged leaf tails included) give
    the bytes of one chunk per leaf."""
    strat, _ = _train(tmp_path)
    strat.close()
    state, diffs = rec.load_latest_chain(CheckpointStore(str(tmp_path)))
    whole = rec.replay_parallel(state["params"], state["opt"], diffs,
                                device="cpu")
    assert rec._chunk_elems(3, 1024) >= max(
        t.size for t in tree_leaves(state["params"]))
    monkeypatch.setattr(rec, "SCRATCH_BYTES", 1)
    assert rec._chunk_elems(3, 1024) == 1024
    chunked = rec.replay_parallel(state["params"], state["opt"], diffs,
                                  device="cpu")
    assert whole[2] == chunked[2] == 3
    for a, b in zip(tree_leaves(whole[:2]), tree_leaves(chunked[:2])):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("window", [None, 2])
def test_replay_parallel_matches_serial_and_reference(tmp_path, window):
    strat, _ = _train(tmp_path)
    strat.close()
    state, diffs = rec.load_latest_chain(CheckpointStore(str(tmp_path)))
    diffs = rec.contiguous_prefix(int(state["step"]), diffs)
    pp, popt, n = rec.replay_parallel(state["params"], state["opt"], diffs,
                                      window=window, device="cpu")
    assert n == len(diffs) == 3 and int(popt.count) == int(
        state["opt"].count) + 3
    sp, sopt = rec.replay_serial(state["params"], state["opt"], diffs,
                                 device="cpu")
    _assert_replay_close(tree_leaves((pp, popt)), tree_leaves((sp, sopt)))
    jstate, jdiffs = jrec.load_latest_chain(JaxStore(str(tmp_path)))
    jdiffs = jrec.contiguous_prefix(int(jstate["step"]), jdiffs)
    jp, jopt, jn = jrec.replay_parallel(jstate["params"], jstate["opt"],
                                        jdiffs, window=window)
    assert jn == n
    _assert_replay_close(tree_leaves((pp, popt.mu, popt.nu)),
                         jax.tree.leaves((jp, jopt.mu, jopt.nu)))


def test_replay_parallel_cuts_at_corrupt_differential(tmp_path):
    strat, _ = _train(tmp_path)
    strat.close()
    state, diffs = rec.load_latest_chain(CheckpointStore(str(tmp_path)))
    bad = dict(diffs[1][1])
    key = sorted(bad)[0]
    sg = bad[key]
    bad[key] = type(sg)(sg.values[:-1], sg.indices[:-1], sg.shape, sg.block)
    diffs = [diffs[0], (diffs[1][0], bad), diffs[2]]
    for window in (None, 1):
        _, opt, n = rec.replay_parallel(state["params"], state["opt"], diffs,
                                        window=window, device="cpu")
        assert n == 1 and int(opt.count) == int(state["opt"].count) + 1
