"""``core/recovery`` (upload and replay): the mean length in ms of the
window's ``recovery.replay`` spans. The span closes once the replay's
kernels are enqueued; the recovery's final synchronize comes after it."""


def read(run):
    spans = [t1 - t0 for name, t0, t1, _ in run.spans
             if name == "recovery.replay"]
    if run.kind != "recover" or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
