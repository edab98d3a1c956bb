"""On the card: a short run of each cell comes out correct. Run there
with ``python -m pytest -m card chipbench/tests``."""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      _bench()["workloads"]])
def test_short_run_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 77), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
