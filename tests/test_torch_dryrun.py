"""The port's dry run (``repro_torch.launch.dryrun``) and report
(``repro_torch.analysis.report``): the CLI on one production combination
in a subprocess (its fake group of 256 ranks never lives in a test
worker), its record against the reference's keys, the reference's and
the port's ``report.py`` on the same JSON, the memory estimate on toy
steps whose live tensors are known, and ``lower_combo``'s process-group
contract (destroyed on the way out, refused inside an initialised
group), the last in a subprocess too."""
import inspect
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import repro.analysis.report as jax_report
import repro.launch.dryrun as jax_dryrun
from repro_torch.analysis import report
from repro_torch.launch.dryrun import run_fake

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE = "qwen2-1.5b", "long_500k"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --arch ... --shape ... --out``
    as ``__main__`` (through runpy, so the child also reports its peak
    resident memory: ``VmHWM``, which, unlike ``ru_maxrss``, starts
    afresh at the exec and does not carry the forking worker's); returns
    (exit code, records, peak RSS in bytes, the process)."""
    out = tmp_path_factory.mktemp("dryrun") / "dryrun.json"
    code = textwrap.dedent(f"""
        import re, runpy, sys
        sys.argv = ["dryrun", "--arch", {ARCH!r}, "--shape", {SHAPE!r},
                    "--out", {str(out)!r}]
        try:
            runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
            rc = 0
        except SystemExit as e:
            rc = e.code
        with open("/proc/self/status") as f:
            print("RSS", re.search(r"VmHWM:\\s+(\\d+)", f.read()).group(1))
        sys.exit(rc)
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), timeout=300, cwd=REPO)
    rss = int(re.search(r"^RSS (\d+)$", p.stdout, re.M).group(1)) * 1024
    with open(out) as f:
        return p.returncode, json.load(f), rss, p


def test_cli_runs_one_combination(cli):
    rc, recs, rss, p = cli
    assert rc == 0, p.stderr[-3000:]
    assert len(recs) == 1
    r = recs[0]
    assert (r["arch"], r["shape"], r["mesh"], r["status"]) == \
        (ARCH, SHAPE, "16x16", "ok")
    assert r["n_devices"] == 256
    assert "1/1 combinations" in p.stdout
    # no real tensor memory: the child's resident set stays far below
    # the bytes the step holds on its (fake) device
    assert r["memory"]["peak_bytes_est"] > 3 * 2**30
    assert rss < r["memory"]["peak_bytes_est"] / 2, (rss, r["memory"])


def _reference_record_keys():
    """Keys that the reference's ``lower_combo`` writes, read from its
    source: the record's own and those of its ``memory`` / ``cost``
    sub-records."""
    src = inspect.getsource(jax_dryrun.lower_combo)
    keys = set(re.findall(r'rec\["(\w+)"\]', src))
    keys |= set(re.findall(r'[{,]\s*"(\w+)":', src))     # dict literals
    return keys


def test_record_has_the_reference_keys(cli):
    _, recs, _, _ = cli
    r = recs[0]
    got = set(r) | set(r["memory"]) | set(r["cost"])
    want = _reference_record_keys() - {"hlo_text"}   # keep_text only
    assert want <= got, want - got
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes",
                                "peak_bytes_est"}
    m = r["memory"]
    assert m["alias_bytes"] == 0
    assert m["peak_bytes_est"] == m["argument_bytes"] + m["output_bytes"] \
        + m["temp_bytes"] - m["alias_bytes"]
    assert r["step_kind"] == "serve_step"
    c = r["collectives"]
    assert c["total"] == sum(v for k, v in c.items()
                             if k not in ("total", "count"))
    assert c["all-gather"] > 0 and r["cost"]["flops"] > 0


def test_report_renders_like_the_reference(cli, toy):
    _, recs, _, _ = cli
    path = toy["dir"]
    dry = os.path.join(path, "dry.json")
    with open(dry, "w") as f:
        json.dump(recs + [{"arch": "x", "shape": "y", "mesh": "16x16",
                           "status": "fail", "error": "E: boom"}], f)
    assert report.dryrun_table(dry) == jax_report.dryrun_table(dry)
    roof = os.path.join(path, "roof.json")
    assert report.roofline_table(roof) == jax_report.roofline_table(roof)
    assert report.roofline_table(roof).count("\n") == 4
    fit = report.fit_table(dry, roof)          # the port's one-cell view
    assert fit.splitlines()[0] == f"| arch | {SHAPE} | y |"
    assert "fail: E: boom" in fit and " / serve" not in fit
    peak = recs[0]["memory"]["peak_bytes_est"] / 2**30
    assert f"| {ARCH} | {peak:.2f} / " in fit


def test_memory_estimate_exact_on_a_toy_step():
    """Arguments 4 KiB; ``a`` and ``b`` 4 KiB each alive together (the
    peak, 12 KiB), ``a`` freed, a view and an in-place op add nothing,
    the 0-d sum adds 4 B; outputs ``b`` and the sum."""
    def step(x):
        a = x * 2
        b = a + 1
        del a
        b[:10].mul_(3)
        return b, b.sum()

    got = run_fake(step, (torch.empty(1024, device="meta"),))
    m = got["memory"]
    assert m["argument_bytes"] == 4096
    assert m["peak_bytes_est"] == 3 * 4096
    assert m["output_bytes"] == 4096 + 4
    assert m["temp_bytes"] == 3 * 4096 - 4096 - 4100
    assert got["cost"]["flops"] == 0


def test_memory_estimate_counts_saved_activations_and_no_real_bytes():
    """A 1 TB argument runs (no byte is allocated). Under autograd the
    exp's result is saved for the backward, so it stays counted after
    its last Python name goes, until the gradient is taken."""
    big = torch.empty(2**38, device="meta")          # 1 TiB of f32

    def step(x, w):
        w = w.requires_grad_(True)
        with torch.enable_grad():
            y = (x[:256] * w).exp()                  # saves y
            z = y.sum()
            del y
            (g,) = torch.autograd.grad(z, [w])
        return g

    got = run_fake(step, (big, torch.empty(256, device="meta")))
    m = got["memory"]
    assert m["argument_bytes"] == 2**40 + 1024
    # x*w (1 KiB), y (saved, 1 KiB), z, then the backward's grad_y and
    # grad_w while y is still held
    assert 2**40 + 1024 + 2 * 1024 < m["peak_bytes_est"] \
        <= 2**40 + 1024 + 5 * 1024 + 8
    assert m["output_bytes"] == 1024


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """In a subprocess: ``lower_combo`` of a reduced qwen2 (2 layers) at
    tiny train / prefill / decode shapes on the production mesh; the
    group's state after; ``lower_combo`` inside an initialised gloo group
    of one rank; and a roofline JSON of the reduced config on one device
    for the report test."""
    d = tmp_path_factory.mktemp("toy")
    code = textwrap.dedent(f"""
        import json, os, sys
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.analysis import roofline
        import repro_torch.launch.dryrun as dr
        small = get_config("qwen2-1.5b").reduced().replace(n_layers=2,
                                                           loss_chunk=64)
        dr.get_config = lambda arch: small
        dr.INPUT_SHAPES = {{"t": ShapeConfig("t", 128, 32, "train"),
                           "p": ShapeConfig("p", 64, 32, "prefill"),
                           "d": ShapeConfig("d", 256, 32, "decode")}}
        out = {{"recs": [dr.lower_combo("qwen2-1.5b", s, keep_text=True)
                         for s in ("t", "p", "d")]}}
        out["after"] = dist.is_initialized()
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join({str(d)!r}, "store"), 1), rank=0, world_size=1)
        try:
            dr.lower_combo("qwen2-1.5b", "t")
            out["refused"] = None
        except RuntimeError as e:
            out["refused"] = str(e)
        out["still"] = dist.is_initialized() and dist.get_backend()
        dist.destroy_process_group()
        rows = [roofline.local_roofline(small, dr.INPUT_SHAPES[s])
                for s in ("t", "p", "d")]
        with open(os.path.join({str(d)!r}, "roof.json"), "w") as f:
            json.dump(rows, f)
        print(json.dumps(out))
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    out["dir"] = str(d)
    return out


def test_lower_combo_destroys_its_group_and_refuses_a_live_one(toy):
    assert toy["after"] is False
    assert toy["refused"] and "already initialised" in toy["refused"]
    assert toy["still"] == "gloo"        # the caller's group is untouched


def test_lower_combo_toy_records(toy):
    from repro.analysis.hlo_stats import collective_bytes as jax_cb
    kinds = {r["mode"]: r for r in toy["recs"]}
    assert set(kinds) == {"train", "prefill", "decode"}
    assert kinds["train"]["step_kind"] == "train_step[lowdiff_sharded]"
    for r in toy["recs"]:
        assert r["status"] == "ok" and r["n_devices"] == 256
        # the kept op record reads the same in the reference's parser
        assert jax_cb(r["hlo_text"]) == r["collectives"]
        m = r["memory"]
        assert m["peak_bytes_est"] >= m["argument_bytes"] > 0
        assert r["cost"]["flops"] > 0
    # the train step gathers and all-reduces every parameter
    c = kinds["train"]["collectives"]
    assert c["all-gather"] > 0 and c["all-reduce"] > 0
