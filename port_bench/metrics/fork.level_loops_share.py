"""Layer ``fork pipeline``: the share of ``fork_pipeline``'s wall that
its two level loops take (stages ``fork.la_scan`` and ``fork.fd`` over
``fork.pipeline``), over the calls the profiler did not record.  Moves
``ordered_events_per_s``."""

from port_bench import stages


def read(run):
    calls = stages.window_calls(run, "fork.upload")
    if calls is None:
        return None
    wall = sum(s["dur_s"] for _, roots in calls
               for s in stages.named(roots, "fork.pipeline"))
    if wall <= 0:
        return None
    return sum(s["dur_s"] for _, roots in calls
               for name in ("fork.la_scan", "fork.fd")
               for s in stages.named(roots, name)) / wall
