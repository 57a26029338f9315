"""Layer ``fork pipeline``: the host's own time a call, in ms: stages
``fork.upload`` and ``fork.pipeline``, their wall less the time they
blocked on the device, the median over the calls the profiler did not
record.  Moves ``ordered_events_per_s``."""

from port_bench import stages
from port_bench.spec import percentile


def read(run):
    calls = stages.window_calls(run, "fork.upload")
    if calls is None:
        return None
    return percentile([stages.host_s(roots) for _, roots in calls],
                      50) * 1e3
