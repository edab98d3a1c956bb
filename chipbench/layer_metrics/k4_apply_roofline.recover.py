"""``kernels/`` K4 in replay: the bytes the replay of the chain's
differentials needs at the card's HBM bandwidth, over the profiled
recoveries' kernel time."""
from chipbench import harness
from chipbench.counts import h100, shapes


def read(run):
    secs = harness.kernel_seconds(run.profile, "topk_apply_kernel")
    if run.kind != "recover" or secs <= 0.0:
        return None
    chain = run.extra["chain"]
    need = shapes.k4_bytes(run.model, run.traffic["rho"]) * chain \
        * run.traffic["profile_recoveries"] / h100.HBM_BW
    return need / secs * 100.0
