"""Nothing the harness runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference, the counts and the inputs import nothing
of the program."""
import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "chipbench")
JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted(
    list(_sources("reference")) + list(_sources("counts"))
    + [os.path.join(BENCH, "inputs.py"), os.path.join(BENCH, "compare.py")]),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_yardstick_imports_no_program(path):
    assert "repro_torch" not in set(_imports(path))


def test_a_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process, then ``sys.modules``."""
    code = (
        "import sys, torch, json\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "torch.set_num_threads(1)\n"
        "from chipbench import harness\n"
        f"cell = harness.load_cell('tiny.lowdiff', {tiny_root!r})\n"
        "harness.run_cell(cell, 3, 0.2, False, torch.device('cpu'))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & JAX
