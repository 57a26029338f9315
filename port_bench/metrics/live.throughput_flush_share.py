"""Layer ``engine``: the share of flushes that leave the latency surface
(attr ``path`` of stage ``live.flush`` other than ``latency``: the
full-table phases, chosen up front or as the latency flush's fallback),
over the flushes the profiler did not record.  Moves
``ordered_events_per_s``."""

from port_bench import stages


def read(run):
    calls = stages.window_calls(run, "live.flush")
    if calls is None:
        return None
    return sum(roots[0]["attrs"].get("path") != "latency"
               for _, roots in calls) / len(calls)
