"""The ``mla_moe`` family (DeepSeek-V2-Lite) in the benchmark: its weight
layout is the program's at full width, its program keys catch a field
that differs, the counts come from it, its cell resolves by name with
its limits and readers, the configuration keeps the catalog's numbers,
and a tiny cell of it runs correct through the harness on the CPU while
a reference without the un-renormalised gates does not."""
import json
import math
import os

import pytest
import torch

from conftest import ROOT, TINY, add_cells

from chipbench import harness, program
from chipbench.counts import shapes
from chipbench.reference import decoder

CONFIG = os.path.join(ROOT, "chipbench", "configs", "deepseek-v2-lite-l5.json")
CELL = "dsv2lite.lowdiff.topk"
#: the tiny sizes: a dense layer and 2 MoE layers holding 4 of 8 experts
TINY_MLA = dict(TINY, mla_moe=(
    "deepseek-v2-lite-l5",
    {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
     "vocab": 256, "param_dtype": "float32", "compute_dtype": "float32"},
    {"head_dim": 16, "n_experts": 8, "held_experts": 4, "top_k": 2,
     "n_shared": 1, "expert_ff": 32, "dense_ff": 128, "kv_lora_rank": 32,
     "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16}))


def _conf():
    with open(CONFIG, encoding="utf-8") as f:
        return json.load(f)


def test_layout_is_the_programs_at_full_width():
    m = _conf()
    model = program.build_model(m)
    dt = decoder.DTYPES[m["param_dtype"]]
    weights = {k: torch.empty(s, dtype=dt, device="meta")
               for k, (s, _) in decoder.param_shapes(m).items()}
    program.check_layout(model, weights)
    assert model.cfg.moe.held_experts == 32 and model.cfg.mla is not None
    del weights["layers.attn.kv_norm"]
    with pytest.raises(ValueError):
        program.check_layout(model, weights)


def _changed(v):
    return (not v) if isinstance(v, bool) else v * 2


@pytest.mark.parametrize("key", sorted(decoder.family(_conf()).PROGRAM_KEYS))
def test_program_keys_catch_a_changed_field(key):
    """The program given another value of each family key (through its
    attribute path) is refused, naming the key."""
    m = _conf()
    path = decoder.family(m).PROGRAM_KEYS[key]
    port = json.loads(json.dumps(m["port_overrides"]))
    cfg = program.arch_config(m)
    node, value = port, cfg
    *outer, last = path.split(".")
    for name in outer:
        node = node.setdefault(name, {})
        value = getattr(value, name)
    node[last] = _changed(getattr(value, last))
    with pytest.raises(ValueError, match=key):
        program.arch_config(dict(m, port_overrides=port))


def test_counts_come_from_the_family():
    """N, the FLOPs of a step of 2 x 4096 and the K1/K4 bytes, against
    counts by hand: MLA 13,763,072 a layer, the dense FFN 67,239,936,
    32 held experts of 8,650,752, 2 shared, the router 131,072."""
    m = _conf()
    d, V = 2048, 102400
    mla = 2048 * 3072 + 2048 * 576 + 512 + 512 * 4096 + 2048 * 2048
    assert mla == 13_763_072
    expert = 3 * d * 1408
    dense_layer = mla + 3 * d * 10944 + 2 * d
    moe_layer = mla + (32 + 2) * expert + d * 64 + 2 * d
    total = dense_layer + 4 * moe_layer + 2 * V * d + d
    assert sum(shapes.leaves(m)) == total == 1_732_534_784
    # a token picks 6 of 64 experts: 3 of the 32 held on average
    n = total - V * d - 4 * (32 - 3) * expert
    assert shapes.active_params(m) == n == 519_332_352
    T, S = 2 * 4096, 4096
    attn = 6 * 5 * 16 * (192 + 128) * S * T
    assert shapes.model_flops(m, 2, 4096) == 6 * n * T + attn
    # leaf sizes by hand: K1 reads f32 and writes 11 picks a 1024-block
    sizes = ([512, d * 576, 512 * 4096, d * d, d * 3072, d,
              10944 * d, d * 10944, d * 10944, d]
             + [V * d, d]
             + [4 * 512, 4 * d * 576, 4 * 512 * 4096, 4 * d * d,
                4 * d * 3072, 4 * d, 4 * d, 4 * d * 64]
             + [4 * 32 * expert // 3] * 3 + [4 * 2 * expert // 3] * 3
             + [d * V])
    assert sum(sizes) == total
    blocks = sum(-(-s // 1024) for s in sizes)
    assert shapes.k1_bytes(m, 0.01) == 4 * total + blocks * 11 * 8
    assert shapes.k4_bytes(m, 0.01) == 2 * (2 + 8) * total + blocks * 11 * 8


def test_the_cell_resolves_with_its_limits_and_readers():
    cell = harness.load_cell(CELL)
    assert cell.model["name"] == "deepseek-v2-lite-l5"
    assert os.path.basename(cell.model["family_file"]) == "mla_moe.py"
    assert cell.traffic["seq"] == 4096 and cell.traffic["batch"] == 2
    assert set(cell.limits["limits"]) >= {"grad1_gap", "dparam3_gap",
                                          "full3_gap", "diff3_gap"}
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    names = {m["name"] for m in harness.per_layer_metrics(bench, cell)}
    assert {"mla_ms.train", "moe_route_ms.train", "fwd_bwd_ms.train",
            "mfu.train"} <= names
    ds = harness.load_cell("dsmoe.lowdiff.topk")
    ds_names = {m["name"] for m in harness.per_layer_metrics(bench, ds)}
    assert "moe_route_ms.train" in ds_names and "mla_ms.train" not in ds_names


@pytest.mark.parametrize("metric,span", [("mla_ms.train", "attn.mla"),
                                         ("moe_route_ms.train", "moe.route")])
def test_span_readers(metric, span):
    """Card ms a step in the metric's spans; None where the program opens
    none (a parent without them) or their card times are missing."""
    mod = harness._load(os.path.join(ROOT, "chipbench", "layer_metrics",
                                     f"{metric}.py"), "m")
    spans = [(span, 0.0, 1.0, {"dev_t0": 1.0, "dev_t1": 1.25}),
             (span, 2.0, 3.0, {"dev_t0": 2.0, "dev_t1": 2.5}),
             ("step.forward", 0.0, 3.0, {"dev_t0": 0.0, "dev_t1": 3.0})]
    run = harness.Run(kind="train", e2e={}, attempted=2, failed=0,
                      memory_peak_bytes=0, numbers={}, units=2, spans=spans)
    assert mod.read(run) == pytest.approx(375.0)
    run.spans = spans[2:]
    assert mod.read(run) is None
    run.spans = [(span, 0.0, 1.0, {})]
    assert mod.read(run) is None


def test_the_file_keeps_the_catalogs_numbers():
    """The catalog's keys (DeepSeek-V2-Lite's config.json) agree with the
    harness's keys; only ``reduced`` keys differ from the published."""
    m = _conf()
    pairs = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads", "vocab_size": "vocab",
             "intermediate_size": "dense_ff",
             "moe_intermediate_size": "expert_ff",
             "n_routed_experts": "held_experts",
             "n_shared_experts": "n_shared",
             "num_experts_per_tok": "top_k",
             "first_k_dense_replace": "first_dense_layers",
             "kv_lora_rank": "kv_lora_rank",
             "qk_nope_head_dim": "qk_nope_head_dim",
             "qk_rope_head_dim": "qk_rope_head_dim",
             "v_head_dim": "v_head_dim", "rms_norm_eps": "norm_eps",
             "rope_theta": "rope_theta"}
    for cat, ours in pairs.items():
        assert m[cat] == m[ours], cat
    assert m["norm_topk_prob"] is m["norm_topk"] is False
    assert m["tie_word_embeddings"] is m["tie_embeddings"] is False
    assert m["q_lora_rank"] is None and m["routed_scaling_factor"] == 1
    y = m["rope_scaling"]
    assert y["type"] == "yarn"
    for k in ("factor", "beta_fast", "beta_slow", "mscale",
              "mscale_all_dim"):
        assert y[k] == m["yarn_" + k]
    assert y["original_max_position_embeddings"] == \
        m["yarn_original_max_position"] == m["context"]
    assert m["n_experts"] == m["published"]["n_routed_experts"] == 64
    assert m["published"]["num_hidden_layers"] == 27
    assert sorted(m["reduced"]) == ["n_routed_experts", "num_hidden_layers"]


def _line(root, name):
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    cell = harness.load_cell(name, root)
    run = harness.run_cell(cell, 2**31 + 41, 0.2, False,
                           torch.device("cpu"))
    return harness.result_line(bench, cell, run, False, "cpu", 1)


def test_a_tiny_cell_runs_correct_and_a_renormalising_reference_does_not(
        tmp_path):
    torch.set_num_threads(1)
    root = str(tmp_path)
    add_cells(root, {"tinymla.lowdiff": ("mla_moe", "lowdiff_topk_b2s4096")},
              tiny=TINY_MLA)
    conf = harness.load_cell("tinymla.lowdiff", root).model
    assert conf["port_overrides"]["moe"]["held_experts"] == 4
    assert conf["port_overrides"]["mla"]["kv_lora_rank"] == 32
    line = _line(root, "tinymla.lowdiff")
    assert line["correct"], line["checks"]
    assert math.isfinite(line["checks"]["loss_gap"]["value"])

    path = os.path.join(root, "chipbench", "reference", "families",
                        "mla_moe.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert src.count('if m["norm_topk"]:') == 1
    with open(path, "w", encoding="utf-8") as f:
        f.write(src.replace('if m["norm_topk"]:', "if True:"))
    line = _line(root, "tinymla.lowdiff")
    assert not line["correct"], line["checks"]
