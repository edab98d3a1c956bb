"""``core/snapshot``: the mean length in seconds of the ``snapshot.d2h``
spans of kind "full" that ended in the window: copying a full off the
card into pinned host memory, on the persist thread. The rest of
``persist_full_s.train`` is the RAM tier's copy."""


def read(run):
    secs = [t1 - t0 for name, t0, t1, a in run.spans
            if name == "snapshot.d2h" and a.get("kind") == "full"]
    if run.kind != "train" or not secs:
        return None
    return sum(secs) / len(secs)
