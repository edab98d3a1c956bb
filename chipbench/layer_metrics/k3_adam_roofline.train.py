"""``kernels/`` K3 ``adam_tile_update``: the bytes one dense Adam step
needs at the card's HBM bandwidth, over the profiled steps' kernel
time."""
from chipbench import harness
from chipbench.counts import h100, shapes


def read(run):
    secs = harness.kernel_seconds(run.profile, "adam_kernel")
    if run.kind != "train" or secs <= 0.0:
        return None
    need = shapes.k3_bytes(run.model) * run.traffic["profile_steps"] \
        / h100.HBM_BW
    return need / secs * 100.0
