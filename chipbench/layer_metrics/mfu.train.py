"""The step (``core/steps``, ``models/``): model FLOPs per step (6 N T +
12 L d S T, ``chipbench/counts/shapes.py``) over the traced run's step
time at the card's dense bfloat16 peak."""
from chipbench.counts import h100, shapes


def read(run):
    if run.kind != "train":
        return None
    step_s = run.e2e["step_ms"] / 1e3
    flops = shapes.model_flops(run.model, run.traffic["batch"],
                               run.traffic["seq"])
    return flops / (step_s * h100.PEAK_BF16_FLOPS) * 100.0
