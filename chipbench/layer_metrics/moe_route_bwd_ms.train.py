"""``models/`` (``models/moe.py``), MoE dispatch, backward: the ms of
card time a window step spent in ``moe.route.bwd`` spans (the backward
of the combine, which gathers each expert slot's gradient and the gates'
dot products, and of the dispatch, which sums each token's slot
gradients), over the window's steps. None where the program opens no
such span."""

NAME = "moe.route.bwd"


def read(run):
    spans = [a for name, _, _, a in run.spans if name == NAME]
    if (run.kind != "train" or not spans
            or any("dev_t1" not in a for a in spans)):
        return None
    return sum(a["dev_t1"] - a["dev_t0"] for a in spans) / run.units * 1e3
