"""Layer ``stream``: the calls that block the host on the device a
batch (``host_reads`` of the batch's root stages: reads to the host,
synchronises and copies from pageable memory), the mean over the
batches the profiler did not record.  Moves
``batch_latency_p95_ms``."""

from port_bench import stages


def read(run):
    calls = stages.window_calls(run, "wide.slice_batch")
    if calls is None:
        return None
    return sum(t["attrs"]["host_reads"] for _, roots in calls
               for t in roots) / len(calls)
