"""``models/`` (``models/mla.py``): the ms of card time a window step
spent in ``attn.mla`` spans, one a multi-head latent attention call
(under remat also its recompute in backward), over the window's steps.
None where the program opens no such span."""

NAME = "attn.mla"


def read(run):
    spans = [a for name, _, _, a in run.spans if name == NAME]
    if (run.kind != "train" or not spans
            or any("dev_t1" not in a for a in spans)):
        return None
    return sum(a["dev_t1"] - a["dev_t0"] for a in spans) / run.units * 1e3
