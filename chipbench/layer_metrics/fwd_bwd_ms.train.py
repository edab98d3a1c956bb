"""``models/``: the ms of card time a window step spent in its
``step.forward`` and ``step.backward`` spans (``dev_t1 - dev_t0``: from
the event at a span's entry to the one at its exit, on the stream the
step runs on), over the window's steps."""

NAMES = ("step.forward", "step.backward")


def read(run):
    spans = [a for name, _, _, a in run.spans if name in NAMES]
    if (run.kind != "train" or not spans
            or any("dev_t1" not in a for a in spans)):
        return None
    return sum(a["dev_t1"] - a["dev_t0"] for a in spans) / run.units * 1e3
