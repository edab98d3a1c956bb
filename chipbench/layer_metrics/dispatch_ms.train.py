"""The step (``core/steps``, ``models/``), host dispatch: the ms of host
time a window step spent inside the ``step`` span, the step function
from its entry to its return, over the window's steps. Once CUDA's
launch queue is full the host waits in a launch, so this reads near
``step_ms`` whichever side sets the pace; how far the card runs behind
the host (``dev_t0 - t0``) tells them apart."""


def read(run):
    secs = [t1 - t0 for name, t0, t1, _ in run.spans if name == "step"]
    if run.kind != "train" or not secs:
        return None
    return sum(secs) / run.units * 1e3
