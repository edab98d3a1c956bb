"""``core/recovery`` and the store's read path: the mean length in ms of
the window's ``recovery.load_chain`` spans (the full and the
differentials copied out of the RAM tier)."""


def read(run):
    spans = [t1 - t0 for name, t0, t1, _ in run.spans
             if name == "recovery.load_chain"]
    if run.kind != "recover" or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
