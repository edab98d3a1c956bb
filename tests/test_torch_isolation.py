"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package, and the entry points
never fall back to the CPU on their own."""
import ast
import os
import pkgutil
import subprocess
import sys

import repro_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.update(extra)
    return env


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_neither_jax_nor_reference():
    mods = _modules()
    assert "repro_torch.launch.train" in mods
    assert "repro_torch.launch.serve" in mods
    assert "repro_torch.kernels.build" in mods
    for m in ("launch.dryrun", "analysis.segments", "analysis.roofline",
              "analysis.hlo_stats", "analysis.report"):
        assert f"repro_torch.{m}" in mods
    code = ("import importlib, sys, json\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imported_names(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_chip_smoke_imports_neither_jax_nor_reference():
    names = set(_imported_names(os.path.join(REPO, "chip_smoke.py")))
    assert any(n.startswith("repro_torch") for n in names)
    for n in names:
        root = n.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), n


def test_port_sources_import_neither_jax_nor_reference():
    src = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _, files in os.walk(src):
        for f in files:
            if f.endswith(".py"):
                for n in _imported_names(os.path.join(dirpath, f)):
                    assert n.split(".")[0] not in ("jax", "jaxlib",
                                                   "repro"), (f, n)


def test_train_without_gpu_or_cpu_flag_raises(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gpt2-l", "--reduced", "--steps", "1", "--ckpt-dir",
         str(tmp_path / "ck")],
        capture_output=True, text=True, env=_env(CUDA_VISIBLE_DEVICES=""),
        timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "step" not in out.stdout


def test_train_default_ckpt_dir_is_under_tmpdir(tmp_path, monkeypatch):
    # --clean wipes --ckpt-dir at launch, so its default must follow the
    # caller's TMPDIR: two checkouts with their own TMPDIR never share it
    import tempfile
    from repro_torch.launch.train import build_parser
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)   # re-read TMPDIR
    args = build_parser().parse_args([])
    assert args.ckpt_dir == os.path.join(str(tmp_path), "repro_ckpt")
    assert args.clean


def test_chip_smoke_refuses_without_gpu(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True,
                         env=_env(CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the repo around it, it refuses too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, env={"PATH": os.environ["PATH"]},
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
