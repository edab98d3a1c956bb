"""Engine (``core/lowdiff``, ``core/reusing_queue``): the ms a window step
was blocked handing its differential to the Reusing Queue, from the
``queue_backpressure`` charges of ``TIMELINE`` over the window's steps."""


def read(run):
    if run.kind != "train" or run.traffic.get("strategy") != "lowdiff":
        return None
    return sum(r.get("queue_backpressure", 0.0)
               for r in run.timeline) / run.units * 1e3
