"""The reader of the MoE dispatch's backward (``moe_route_bwd_ms.train``):
card ms a step in ``moe.route.bwd`` spans; None where the program opens
none (a parent without them) or their card times are missing; reported
in both MoE cells and in no other."""
import json
import os

import pytest

from chipbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METRIC = "moe_route_bwd_ms.train"


def _reader():
    return harness._load(os.path.join(ROOT, "chipbench", "layer_metrics",
                                      f"{METRIC}.py"), "m")


@pytest.mark.parametrize("kind,want", [("train", 375.0), ("recover", None)])
def test_reads_card_ms_a_step_of_its_spans(kind, want):
    spans = [("moe.route.bwd", 0.0, 1.0, {"dev_t0": 1.0, "dev_t1": 1.25}),
             ("moe.route.bwd", 2.0, 3.0, {"dev_t0": 2.0, "dev_t1": 2.5}),
             ("moe.route", 0.0, 3.0, {"dev_t0": 0.0, "dev_t1": 3.0})]
    run = harness.Run(kind=kind, e2e={}, attempted=2, failed=0,
                      memory_peak_bytes=0, numbers={}, units=2, spans=spans)
    got = _reader().read(run)
    assert got == (want if want is None else pytest.approx(want))


@pytest.mark.parametrize("spans", [
    [("moe.route", 0.0, 1.0, {"dev_t0": 0.0, "dev_t1": 1.0})],
    [("moe.route.bwd", 0.0, 1.0, {})]], ids=["parent", "no-card-times"])
def test_silent_without_its_spans_or_their_card_times(spans):
    run = harness.Run(kind="train", e2e={}, attempted=2, failed=0,
                      memory_peak_bytes=0, numbers={}, units=2, spans=spans)
    assert _reader().read(run) is None


@pytest.mark.parametrize("cell", ["dsmoe.lowdiff.topk",
                                  "dsv2lite.lowdiff.topk",
                                  "gpt2l.lowdiff.topk", "gpt2l.dense"])
def test_reported_in_the_moe_cells_only(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    names = {m["name"] for m in harness.per_layer_metrics(
        bench, harness.load_cell(cell))}
    assert (METRIC in names) == cell.startswith("ds")
