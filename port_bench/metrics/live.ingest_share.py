"""Layer ``engine``: the share of the flushes' wall that their ingest
takes (stages ``live.ingest`` over ``live.flush``: the incremental
coordinate fill and the rounds' level scan, or the throughput path's
ingest), over the flushes the profiler did not record.  Moves
``ordered_events_per_s``."""

from port_bench import stages


def read(run):
    calls = stages.window_calls(run, "live.flush")
    if calls is None:
        return None
    wall = sum(roots[0]["dur_s"] for _, roots in calls)
    if wall <= 0:
        return None
    return sum(s["dur_s"] for _, roots in calls
               for s in stages.named(roots, "live.ingest")) / wall
