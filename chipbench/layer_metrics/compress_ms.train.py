"""``compression/`` (error feedback, K1, K2): the ms of card time a
window step spent in its ``step.compress`` span (``dev_t1 - dev_t0``),
over the window's steps."""


def read(run):
    spans = [a for name, _, _, a in run.spans if name == "step.compress"]
    if (run.kind != "train" or not spans
            or any("dev_t1" not in a for a in spans)):
        return None
    return sum(a["dev_t1"] - a["dev_t0"] for a in spans) / run.units * 1e3
