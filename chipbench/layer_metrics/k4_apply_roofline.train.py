"""``kernels/`` K4 ``topk_apply`` in the step: the bytes one step's
decode-and-apply needs at the card's HBM bandwidth, over the profiled
steps' kernel time."""
from chipbench import harness
from chipbench.counts import h100, shapes


def read(run):
    secs = harness.kernel_seconds(run.profile, "topk_apply_kernel")
    if run.kind != "train" or secs <= 0.0:
        return None
    need = shapes.k4_bytes(run.model, run.traffic["rho"]) \
        * run.traffic["profile_steps"] / h100.HBM_BW
    return need / secs * 100.0
