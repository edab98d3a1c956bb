"""``checkpoint/`` (store, RAM tier, frame codec): the mean length in
seconds of the ``persist.full`` spans that ended in the window: copying
the snapshot off the card and into the RAM tier."""


def read(run):
    spans = [t1 - t0 for name, t0, t1, _ in run.spans
             if name == "persist.full"]
    if run.kind != "train" or not spans:
        return None
    return sum(spans) / len(spans)
