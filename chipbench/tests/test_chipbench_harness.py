"""The harness finds everything of a cell by name, in files; a cell added
as new files only runs; the command refuses to run without a card."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from conftest import CELLS, ROOT

from chipbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["chipbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    used = {w["config"] for w in b["workloads"]}
    assert set(names) == used and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        assert all(k in conf["published"] for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        reports = [e for e in b["end_to_end"] if e["name"] == m["moves"]]
        for w in m["workloads"]:
            assert w in reports[0].get("workloads", [w])


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      _bench()["workloads"]])
def test_cell_resolves_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.model["name"] == cell.workload["config"]
    assert callable(harness.driver(cell).run)
    assert cell.limits["limits"], "every cell has its limits file"
    metrics = harness.per_layer_metrics(_bench(), cell)
    assert metrics
    for m in metrics:
        path = os.path.join(ROOT, "chipbench", "layer_metrics",
                            f"{m['name']}.py")
        assert callable(harness._load(path, "m").read)


#: the recover cell, out of BENCHMARK.json until its host read path is
#: steady (PERF.md, Open questions): entries that bring it back
RECOVER = {
    "workload": {"name": "gpt2l.recover.device", "config": "gpt2-l",
                 "traffic": "recover_topk_f20_device", "chips": 1,
                 "why": "device-replay recoveries of a full and its 19 "
                        "differentials from the RAM tier"},
    "end_to_end": {"name": "recovery_ms", "unit": "ms", "better": "lower",
                   "bound": 0.25, "source": "host_clock",
                   "workloads": ["gpt2l.recover.device"]},
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "recovery_ms",
         "workloads": ["gpt2l.recover.device"]}
        for name, unit, better, source, layer in [
            ("load_ms.recover", "ms", "lower", "program_span",
             "core/recovery and the store's read path"),
            ("replay_ms.recover", "ms", "lower", "program_span",
             "core/recovery (upload and replay)"),
            ("k4_apply_roofline.recover", "%", "higher", "device_trace",
             "kernels/"),
            ("device_idle_pct.recover", "%", "lower", "device_trace",
             "device")]],
}


def test_recover_cell_comes_back_as_entries_only(tmp_path):
    import shutil
    shutil.copytree(os.path.join(ROOT, "chipbench"), tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _bench()
    bench["workloads"].append(RECOVER["workload"])
    bench["end_to_end"].append(RECOVER["end_to_end"])
    bench["per_layer"] += RECOVER["per_layer"]
    with open(tmp_path / "BENCHMARK.json", "w", encoding="utf-8") as f:
        json.dump(bench, f)
    cell = harness.load_cell("gpt2l.recover.device", str(tmp_path))
    assert callable(harness.driver(cell).run)
    assert cell.limits["limits"]["recoveries_unequal"] == 0
    metrics = harness.per_layer_metrics(bench, cell)
    assert {m["name"] for m in metrics} == {m["name"] for m in
                                            RECOVER["per_layer"]}
    for m in metrics:
        path = os.path.join(tmp_path, "chipbench", "layer_metrics",
                            f"{m['name']}.py")
        assert callable(harness._load(path, "m").read)


def test_configs_match_the_program():
    from chipbench import program
    for c in _bench()["configs"]:
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            program.arch_config(json.load(f))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_added_as_files_runs_on_the_cpu_hook(tiny_root, name):
    with open(os.path.join(tiny_root, "BENCHMARK.json"),
              encoding="utf-8") as f:
        bench = json.load(f)
    cell = harness.load_cell(name, tiny_root)
    run = harness.run_cell(cell, 2**31 + 11, 0.3, False,
                           torch.device("cpu"))
    line = harness.result_line(bench, cell, run, False, "cpu", 1)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = "recovery_ms" if "recover" in name else "step_ms"
    assert set(line["metrics"]) == {e2e, "setup_s"}
    assert line["metrics"][e2e]["value"] > 0


def test_same_seed_same_inputs():
    from chipbench import inputs
    with open(os.path.join(ROOT, "chipbench", "configs", "gpt2-l.json"),
              encoding="utf-8") as f:
        m = json.load(f)
    m = dict(m, n_layers=1, d_model=32, head_dim=8, n_heads=4,
             n_kv_heads=4, d_ff=64, vocab=97)
    seed = 2**31 + 5
    a, b = inputs.weights(m, seed, "cpu"), inputs.weights(m, seed, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = inputs.weights(m, seed + 1, "cpu")
    assert not torch.equal(a["lm_head"], c["lm_head"])
    x = next(inputs.Batches(97, 2, 16, seed, "cpu"))
    y = next(inputs.Batches(97, 2, 16, seed, "cpu"))
    assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(x["tokens"][:, 1:], x["targets"][:, :-1])


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", "gpt2l.dense",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_command_refuses_in_a_bare_checkout(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "chipbench"), tmp_path / "chipbench")
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", "gpt2l.dense",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_trace_summary_reads_busy_and_gaps():
    ev = [{"ph": "X", "cat": "user_annotation", "name":
           "chipbench.profiled", "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5.0,
           "dur": 30.0},
          {"ph": "X", "cat": "kernel", "name": "topk_select_kernel<f>",
           "ts": 10.0, "dur": 20.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 25.0, "dur": 15.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60.0,
           "dur": 10.0}]
    s = harness.summarize_trace(ev)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert harness.kernel_seconds(s, "topk_select_kernel") == \
        pytest.approx(20e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(10e-6)        # 0..10
    assert gaps["host outside any op"] == pytest.approx(50e-6)
