"""A run whose timed path is broken underneath comes out not correct:
once for each fault its cell can have. Driven on the CPU through the
harness's test hook, the chip look skipped."""
import json
import os

import pytest
import torch

from chipbench import harness

CPU = torch.device("cpu")


def _correct(root, name):
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    cell = harness.load_cell(name, root)
    run = harness.run_cell(cell, 2**31 + 23, 0.2, False, CPU)
    return harness.result_line(bench, cell, run, False, "cpu", 1)["correct"]


def _unchanged(step):
    """A step that returns its state unchanged (metrics as computed)."""
    def broken(state, batch):
        out = step(state, batch)
        return (state,) + tuple(out[1:])
    return broken


def _half(step):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(state, batch):
        n = batch["tokens"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half])
@pytest.mark.parametrize("name", ["tiny.lowdiff", "tinymoe.lowdiff"])
def test_lowdiff_step_fault(tiny_root, monkeypatch, name, fault):
    from repro_torch.core import lowdiff
    make = lowdiff.make_train_step
    monkeypatch.setattr(lowdiff, "make_train_step",
                        lambda *a, **k: fault(make(*a, **k)))
    assert _correct(tiny_root, name) is False


@pytest.mark.parametrize("fault", [_unchanged, _half])
def test_dense_step_fault(tiny_root, monkeypatch, fault):
    from repro_torch.core import steps
    make = steps.make_train_step
    monkeypatch.setattr(steps, "make_train_step",
                        lambda *a, **k: fault(make(*a, **k)))
    assert _correct(tiny_root, "tiny.dense") is False


def test_recover_fault_state_unchanged(tiny_root, monkeypatch):
    """A replay that applies nothing and reports the chain applied."""
    from repro_torch.core import recovery
    replay = recovery.replay_device

    def broken(params, opt, diffs, **kw):
        p, o, _ = replay(params, opt, [], **kw)
        return p, o, len(diffs)
    monkeypatch.setattr(recovery, "replay_device", broken)
    assert _correct(tiny_root, "tiny.recover") is False


def test_recover_fault_answer_altered(tiny_root, monkeypatch):
    """One differential's values altered where recovery reads them."""
    from repro_torch.core import recovery
    from repro_torch.compression.sparse import SparseGrad
    replay = recovery.replay_device

    def broken(params, opt, diffs, **kw):
        step, pay = diffs[-1]
        pay = {**pay}
        leaf = next(iter(sorted(pay["layers"]["attn"])))
        sg = pay["layers"]["attn"][leaf]
        pay["layers"] = {**pay["layers"], "attn": {
            **pay["layers"]["attn"],
            leaf: SparseGrad(-sg.values, sg.indices, sg.shape, sg.block)}}
        return replay(params, opt, diffs[:-1] + [(step, pay)], **kw)
    monkeypatch.setattr(recovery, "replay_device", broken)
    assert _correct(tiny_root, "tiny.recover") is False


@pytest.mark.parametrize("name", ["tiny.lowdiff", "tinymoe.lowdiff",
                                  "tiny.dense", "tiny.recover"])
def test_control_is_not_correct(tiny_root, name):
    """The control (the reference in float8, put in the program's place;
    for a replay, Adam in bfloat16) and the half-batch fault each fail a
    number of the cell."""
    from chipbench import compare, control
    cell = harness.load_cell(name, tiny_root)
    for what, numbers in control.readings(cell, CPU, 2**31 + 41, True):
        checks = compare.judge(numbers, cell.limits)
        assert not compare.passed(checks), (what, checks)
