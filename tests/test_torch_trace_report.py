"""The port's ``trace_report`` against the reference's: both print the
same text, and return the same code, for the same ``--trace-out`` /
``--metrics-out`` files, one pair written by the port's own training
CLI (with ``--compare`` against a second run) and one written here."""
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from repro.analysis import trace_report as ref
from repro_torch.analysis import trace_report as mine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"    # the suite runs six workers at once
    return env


def _report(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """A LowDiff run with a failure and a ``--strategy none`` run of the
    port's CLI, each writing its trace and metrics files."""
    root = tmp_path_factory.mktemp("runs")
    files = {}
    for name, extra in (("lowdiff", ["--full-interval", "4", "--fail-at",
                                     "5", "--trace-out",
                                     str(root / "lowdiff.json")]),
                        ("none", ["--strategy", "none"])):
        metrics = str(root / f"{name}.jsonl")
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--device",
             "cpu", "--arch", "gpt2-l", "--reduced", "--steps", "6",
             "--ckpt-dir", str(root / f"ck_{name}"), "--log-every", "0",
             "--metrics-out", metrics] + extra,
            capture_output=True, text=True, env=_env(), timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        files[name] = metrics
    files["trace"] = str(root / "lowdiff.json")
    return files


def _argvs(trace, metrics, base):
    return [["--trace", trace],
            ["--metrics", metrics],
            ["--trace", trace, "--metrics", metrics, "--top", "4"],
            ["--metrics", metrics, "--compare", base,
             "--assert-attribution", "0.95", "--assert-overhead", "1e9"],
            ["--metrics", metrics, "--compare", base,
             "--assert-overhead=-1e9"],
            ["--metrics", metrics, "--assert-attribution", "2.0"]]


@pytest.mark.parametrize("case", range(6))
def test_port_cli_files_render_identically(cli_runs, case):
    argv = _argvs(cli_runs["trace"], cli_runs["lowdiff"],
                  cli_runs["none"])[case]
    got, want = _report(mine, argv), _report(ref, argv)
    assert got == want
    assert got[1].strip()
    if "--trace" in argv:
        assert "snapshot" in got[1] or "persist" in got[1]


def test_module_cli_prints_the_same(cli_runs):
    argv = ["--trace", cli_runs["trace"], "--metrics", cli_runs["lowdiff"],
            "--compare", cli_runs["none"]]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.trace_report"] + argv,
        capture_output=True, text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout == _report(ref, argv)[1]


@pytest.fixture
def written(tmp_path):
    events = [
        {"name": "ckpt.offload", "cat": "persist", "ph": "X", "pid": 1,
         "tid": 2, "ts": 10.0, "dur": 1500.0, "args": {"step": 3}},
        {"name": "snapshot.d2h", "cat": "snapshot", "ph": "X", "pid": 1,
         "tid": 3, "ts": 12.0, "dur": 250.5},
        {"name": "nocat", "ph": "X", "pid": 1, "tid": 3, "ts": 13.0,
         "dur": 7.0},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 3,
         "args": {"name": "persist"}},
        {"name": "mark", "ph": "i", "pid": 1, "tid": 2, "ts": 20.0}]
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    recs = [{"kind": "step", "step": 1, "wall": 0.5, "compute": 0.4,
             "snapshot_stall": 0.1},
            {"kind": "step", "step": 2, "wall": 0.25, "compute": 0.25},
            {"kind": "step", "step": 3, "wall": 0.75, "compute": 0.5,
             "flush_stall": 0.25},
            {"kind": "step", "wall": 2.0, "recovery": 2.0,
             "out_of_step": True},
            {"kind": "metric", "name": "store.writes", "value": 4}]
    metrics = tmp_path / "m.jsonl"
    metrics.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    base = tmp_path / "b.jsonl"
    base.write_text(json.dumps({"kind": "step", "wall": 0.4}) + "\n")
    return str(trace), str(metrics), str(base)


@pytest.mark.parametrize("case", range(6))
def test_written_files_render_identically(written, case):
    argv = _argvs(*written)[case]
    assert _report(mine, argv) == _report(ref, argv)


def test_malformed_trace_is_refused_alike(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "x", "ph": "X",
                                                "pid": 1, "tid": 1}]}))
    errs = []
    for module in (mine, ref):
        with pytest.raises(ValueError) as e:
            module.load_chrome_trace(str(bad))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
