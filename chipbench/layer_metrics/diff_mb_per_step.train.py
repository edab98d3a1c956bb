"""``compression/`` and ``checkpoint/``: the differential bytes the store
took in the window, in MB (1e6 B), over the differentials written: the
``bytes`` and ``n`` of each ``store.save_batch`` span. A count."""


def read(run):
    spans = [a for name, _, _, a in run.spans if name == "store.save_batch"]
    n = sum(a.get("n", 0) for a in spans)
    if run.kind != "train" or not n:
        return None
    return sum(a["bytes"] for a in spans) / n / 1e6
