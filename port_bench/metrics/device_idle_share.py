"""Layer ``device``: 1 - (union of kernel, copy and set intervals) /
traced window, from ``torch.profiler``.  Moves
``ordered_events_per_s``."""


def read(run):
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
