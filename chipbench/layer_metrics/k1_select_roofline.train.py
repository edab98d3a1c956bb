"""``kernels/`` K1 ``topk_select``: the bytes one step's selection needs
at the card's HBM bandwidth, over the profiled steps' kernel time."""
from chipbench import harness
from chipbench.counts import h100, shapes


def read(run):
    secs = harness.kernel_seconds(run.profile, "topk_select_kernel")
    if run.kind != "train" or secs <= 0.0:
        return None
    need = shapes.k1_bytes(run.model, run.traffic["rho"]) \
        * run.traffic["profile_steps"] / h100.HBM_BW
    return need / secs * 100.0
