"""Layer ``stream``: the host's own time a batch, in ms: over the root
stages of one batch (``wide.slice_batch``, ``wide.schedule``,
``wide.ingest``, ``wide.consensus``, ``wide.compact``) their wall less
the time they blocked on device reads, the median over the batches the
profiler did not record.  Moves ``batch_latency_p95_ms``."""

from port_bench import stages
from port_bench.spec import percentile


def read(run):
    calls = stages.window_calls(run, "wide.slice_batch")
    if calls is None:
        return None
    return percentile([stages.host_s(roots) for _, roots in calls],
                      50) * 1e3
