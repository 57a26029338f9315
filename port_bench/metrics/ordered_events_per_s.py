"""End to end: events given their final consensus position in the
window, over the window's seconds (host clock; the window ends with a
device read)."""


def read(run):
    if run["window_s"] <= 0:
        return None
    return run["ordered"] / run["window_s"]
