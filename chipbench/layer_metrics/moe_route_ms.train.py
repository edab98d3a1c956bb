"""``models/`` (``models/moe.py``), MoE dispatch: the ms of card time a
window step spent in ``moe.route`` spans (the router, its gates, each
assignment's slot and the scatter into the expert buffers; under remat
also their recompute in backward), over the window's steps. The index
backward of that scatter runs outside the span. None where the program
opens no such span."""

NAME = "moe.route"


def read(run):
    spans = [a for name, _, _, a in run.spans if name == NAME]
    if (run.kind != "train" or not spans
            or any("dev_t1" not in a for a in spans)):
        return None
    return sum(a["dev_t1"] - a["dev_t0"] for a in spans) / run.units * 1e3
