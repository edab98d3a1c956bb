"""Fixtures of the benchmark's tests: a copy of the benchmark with tiny
cells added as new files only, run on the CPU through the harness's test
hook. Tests that need the card carry the ``card`` marker and decide
inside the test whether one is there."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from chipbench.reference import decoder  # noqa: E402

#: tiny sizes of each configuration family; the program gets the same
#: sizes through ``port_overrides``
TINY = {
    "dense": ("gpt2-l", {"n_layers": 2, "d_model": 64, "n_heads": 4,
                         "n_kv_heads": 4, "d_ff": 128, "vocab": 256,
                         "compute_dtype": "float32"}, {"head_dim": 16}),
    "moe": ("deepseek-moe-16b-l2",
            {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
             "vocab": 256, "param_dtype": "float32",
             "compute_dtype": "float32"},
            {"head_dim": 16, "n_experts": 8, "top_k": 2, "n_shared": 1,
             "expert_ff": 32}),
}
#: tiny cells: name -> (family, traffic file it shrinks)
CELLS = {
    "tiny.lowdiff": ("dense", "lowdiff_topk_b4s1024"),
    "tiny.dense": ("dense", "dense_b4s1024"),
    "tiny.recover": ("dense", "recover_topk_f20_device"),
    "tinymoe.lowdiff": ("moe", "lowdiff_topk_b2s4096"),
}
#: limits of the tiny cells: float32 on the CPU reads under 5e-4
TINY_LIMIT = 5e-3


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


def _tiny_config(family: str, tiny=TINY, families=None) -> dict:
    """The tiny configuration of ``family`` (sizes from ``tiny``); the
    family's own keys reach the program through its ``PROGRAM_KEYS``
    attribute paths, ``"moe.n_experts"`` as ``{"moe": {"n_experts"}}``.
    ``families``: the directory of the family's file, if not the
    benchmark's own."""
    base, over, extra = tiny[family]
    with open(os.path.join(ROOT, "chipbench", "configs", f"{base}.json"),
              encoding="utf-8") as f:
        conf = json.load(f)
    conf.update(over, **extra)
    conf.update(name=f"tiny-{family}", family=family)
    fam = decoder.family(dict(conf, family_file=families and os.path.join(
        families, f"{family}.py")))
    port = dict(over)
    for k, path in fam.PROGRAM_KEYS.items():
        if k in extra:
            *outer, last = path.split(".")
            node = port
            for name in outer:
                node = node.setdefault(name, {})
            node[last] = extra[k]
    conf["port_overrides"] = port
    return conf


def _tiny_traffic(name: str) -> dict:
    with open(os.path.join(ROOT, "chipbench", "traffic", f"{name}.json"),
              encoding="utf-8") as f:
        t = json.load(f)
    t.update(batch=4 if t["batch"] == 2 else 2, seq=32)
    if t["kind"] == "recover":
        t.update(full_interval=4, start_step=3, chain_steps=4)
    elif t["strategy"] == "lowdiff":
        t.update(full_interval=4, start_step=1)
    return t


def add_cells(root: str, cells=CELLS, limit: float = TINY_LIMIT,
              tiny=TINY, families=()) -> dict:
    """Copy the benchmark under ``root`` and add ``cells`` as new files
    and new entries only (``families``: family files to add); returns
    the new BENCHMARK.json."""
    shutil.copytree(os.path.join(ROOT, "chipbench"),
                    os.path.join(root, "chipbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    fams = os.path.join(root, "chipbench", "reference", "families")
    for path in families:
        shutil.copy(path, fams)
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    d = os.path.join(root, "chipbench")
    for family in {f for f, _ in cells.values()}:
        conf = _tiny_config(family, tiny, fams)
        path = f"chipbench/configs/{conf['name']}.json"
        with open(os.path.join(root, path), "w", encoding="utf-8") as f:
            json.dump(conf, f)
        bench["configs"].append({"name": conf["name"], "source": "tiny",
                                 "file": path, "reduced": [],
                                 "why": "tiny"})
    for name, (family, traffic) in cells.items():
        tname = f"tiny_{traffic}"
        with open(os.path.join(d, "traffic", f"{tname}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(_tiny_traffic(traffic), f)
        bench["workloads"].append({"name": name,
                                   "config": f"tiny-{family}",
                                   "traffic": tname, "chips": 1,
                                   "why": "tiny"})
        kind = "recover" if "recover" in traffic else "train"
        names = (["replay_gap", "recoveries_unequal", "grad1_gap",
                  "dparam1_gap", "diff2_gap"] if kind == "recover" else
                 ["loss_gap", "grad1_gap", "dparam3_gap", "full3_gap",
                  "diff3_gap"])
        with open(os.path.join(d, "limits", f"{name}.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"limits": dict({n: limit for n in names},
                                      recoveries_unequal=0)}, f)
    if (any("recover" in t for _, t in cells.values())
            and "recovery_ms" not in {m["name"] for m in bench["end_to_end"]}):
        # a recover cell brings its end-to-end metric as a new entry
        bench["end_to_end"].append({"name": "recovery_ms", "unit": "ms",
                                    "better": "lower", "bound": 0.25,
                                    "source": "host_clock",
                                    "workloads": []})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [n for n, (_, t) in cells.items()
                               if (m["name"] == "recovery_ms")
                               == ("recover" in t)]
    with open(os.path.join(root, "BENCHMARK.json"), "w",
              encoding="utf-8") as f:
        json.dump(bench, f)
    return bench


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("bench"))
    add_cells(root)
    return root
