"""A model family is files only: a family added to a copy of the
benchmark as one file under ``chipbench/reference/families/`` runs a
cell that comes out correct, and the same family with its window left
out comes out not correct; the files that the benchmark shares name no
family."""
import filecmp
import json
import os

import pytest
import torch

from conftest import ROOT, TINY, add_cells

from chipbench import harness

WINDOW = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "families", "window.py")
#: the tiny dense sizes, windows of 8 keys on every layer but layer 1
TINY_WINDOW = dict(TINY, window=("gpt2-l", TINY["dense"][1],
                                 {"head_dim": 16, "window": 8,
                                  "global_layers": [1]}))
CELL = {"tinywin.lowdiff": ("window", "lowdiff_topk_b4s1024")}


def _json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _only_appended(old, new):
    """``new`` is ``old`` with entries appended to its lists, and names
    appended to each entry's ``workloads``."""
    if isinstance(old, dict):
        return (isinstance(new, dict) and set(old) == set(new)
                and all(_only_appended(old[k], new[k]) for k in old))
    if isinstance(old, list):
        return (isinstance(new, list) and len(new) >= len(old)
                and all(_only_appended(a, b) for a, b in zip(old, new)))
    return old == new


def _repo_files_unchanged(copy):
    """Every file of the repository's benchmark (its tests aside) is in
    ``copy`` byte for byte."""
    src = os.path.join(ROOT, "chipbench")
    for d, dirs, files in os.walk(src):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".pyc"):
                continue
            rel = os.path.relpath(os.path.join(d, f), src)
            other = os.path.join(copy, "chipbench", rel)
            assert os.path.isfile(other), rel
            assert filecmp.cmp(os.path.join(d, f), other, shallow=False), rel


def _correct(root, name):
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cell = harness.load_cell(name, root)
    run = harness.run_cell(cell, 2**31 + 29, 0.2, False,
                           torch.device("cpu"))
    return harness.result_line(bench, cell, run, False, "cpu", 1)


def test_a_family_added_as_a_file(tmp_path):
    torch.set_num_threads(1)
    root = str(tmp_path)
    add_cells(root, CELL, tiny=TINY_WINDOW, families=[WINDOW])
    assert _only_appended(_json(os.path.join(ROOT, "BENCHMARK.json")),
                          _json(os.path.join(root, "BENCHMARK.json")))
    _repo_files_unchanged(root)
    conf = _json(os.path.join(root, "chipbench", "configs",
                              "tiny-window.json"))
    assert conf["port_overrides"]["sliding_window"] == 8
    assert conf["port_overrides"]["global_attn_layers"] == [1]

    line = _correct(root, "tinywin.lowdiff")
    assert line["correct"], line["checks"]

    # the same family with its window left out: every layer attends to
    # the whole sequence, as the program's does not
    with open(WINDOW, encoding="utf-8") as f:
        src = f.read()
    path = os.path.join(root, "chipbench", "reference", "families",
                        "window.py")
    with open(path, "w", encoding="utf-8") as f:
        f.write(src + "\n\ndef layer_window(m, i):\n    return None\n")
    line = _correct(root, "tinywin.lowdiff")
    assert not line["correct"], line["checks"]


def test_the_program_keys_are_checked(tmp_path):
    """A configuration whose family keys the program does not hold is
    refused: a window the program's ``ArchConfig`` does not have."""
    from conftest import _tiny_config
    from chipbench import program
    fams = os.path.dirname(WINDOW)
    m = _tiny_config("window", TINY_WINDOW, fams)
    m["family_file"] = WINDOW
    program.arch_config(m)
    bad = dict(m, port_overrides=dict(m["port_overrides"],
                                      sliding_window=16))
    with pytest.raises(ValueError, match="window"):
        program.arch_config(bad)
    with pytest.raises(ValueError, match="arch_type"):
        program.arch_config(dict(m, port_arch="deepseek-moe-16b"))


@pytest.mark.parametrize("name", ["reference/decoder.py", "counts/shapes.py",
                                  "program.py"])
def test_shared_files_name_no_family(name):
    fams = os.path.join(ROOT, "chipbench", "reference", "families")
    names = [f[:-3] for f in os.listdir(fams) if f.endswith(".py")]
    assert {"dense", "moe"} <= set(names)
    with open(os.path.join(ROOT, "chipbench", name), encoding="utf-8") as f:
        src = f.read()
    assert '["family"] ==' not in src and "['family'] ==" not in src
    assert "moe" not in src.lower()
    if name != "program.py":      # there "dense" is the step's mode
        assert all(f'"{n}"' not in src for n in names)


def test_a_family_picks_each_layers_weights(tmp_path):
    """``layer_params(params, i)``, where a family gives it, picks layer
    i's weights (here the default's slice, each call counted): the same
    loss and gradients, bit for bit, as the family without it."""
    from conftest import _tiny_config
    from chipbench import inputs
    from chipbench.reference import decoder
    with open(os.path.join(ROOT, "chipbench", "reference", "families",
                           "dense.py"), encoding="utf-8") as f:
        src = f.read()
    path = tmp_path / "dense.py"
    path.write_text(src + (
        "\n\nPICKED = []\n\n\ndef layer_params(params, i):\n"
        "    PICKED.append(i)\n"
        "    return decoder.layer(params['layers'], i)\n"), encoding="utf-8")
    m = _tiny_config("dense")
    w = inputs.weights(m, 7, "cpu")
    batch = next(inputs.Batches(m["vocab"], 2, 16, 7, "cpu"))
    prec = decoder.Precision(torch.float32)
    loss, grads = decoder.gradients(w, batch, m, prec)
    mine = dict(m, family_file=str(path))
    loss2, grads2 = decoder.gradients(w, batch, mine, prec)
    assert decoder.family(mine).PICKED == list(range(m["n_layers"]))
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[k], grads2[k]) for k in grads)
