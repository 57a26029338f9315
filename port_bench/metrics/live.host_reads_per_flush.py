"""Layer ``engine``: the calls that block the host on the device a
flush (``host_reads`` of stage ``live.flush``: reads to the host,
synchronises and copies from pageable memory), the mean over the
flushes the profiler did not record.  Moves
``ordered_events_per_s``."""

from port_bench import stages


def read(run):
    calls = stages.window_calls(run, "live.flush")
    if calls is None:
        return None
    return sum(roots[0]["attrs"]["host_reads"]
               for _, roots in calls) / len(calls)
