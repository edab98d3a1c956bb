"""``core/snapshot``: the ms a window step was blocked waiting for a
snapshot-arena permit, from the ``snapshot_stall`` charges of
``TIMELINE`` over the window's steps."""


def read(run):
    if run.kind != "train" or run.traffic.get("strategy") != "lowdiff":
        return None
    return sum(r.get("snapshot_stall", 0.0)
               for r in run.timeline) / run.units * 1e3
