"""The port's LowDiff end to end on the CPU (reduced gpt2-l): the
training CLI recovers from an injected failure, the recovered params and
optimizer state equal the trained ones bit for bit, device replay equals
serial replay bit for bit, and parallel recovery is refused."""
import os
import subprocess
import sys

import pytest
import torch

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
    strat, state = _train(tmp_path, replay_device=replay_device)
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


def test_parallel_recovery_is_refused(tmp_path):
    model = build_model(get_config("gpt2-l").reduced())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LowDiff(model, CheckpointStore(str(tmp_path)),
                parallel_recovery=True, device="cpu")
