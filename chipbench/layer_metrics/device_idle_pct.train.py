"""The device in training: the share of the profiled steps' window in
which no kernel, copy or fill ran on the card (``torch.profiler``)."""


def read(run):
    p = run.profile
    if run.kind != "train" or not p or p["window_s"] <= 0.0:
        return None
    return (1.0 - p["busy_s"] / p["window_s"]) * 100.0
