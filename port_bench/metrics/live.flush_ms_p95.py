"""Layer ``engine``: the 95th percentile of one ``run_consensus_timed``
(stage ``live.flush``, the node's flush: build, ingest, fame, order,
the first read, the commit and the rolling window), over the flushes
the profiler did not record, in ms.  Moves ``ordered_events_per_s``."""

from port_bench import stages
from port_bench.spec import percentile


def read(run):
    calls = stages.window_calls(run, "live.flush")
    if calls is None:
        return None
    return percentile([roots[0]["dur_s"] for _, roots in calls], 95) * 1e3
