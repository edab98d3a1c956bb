"""The device in recovery: the share of the profiled recovery's window in
which no kernel, copy or fill ran on the card (``torch.profiler``)."""


def read(run):
    p = run.profile
    if run.kind != "recover" or not p or p["window_s"] <= 0.0:
        return None
    return (1.0 - p["busy_s"] / p["window_s"]) * 100.0
