"""Layer ``stream``: the share of the batches' wall that the stream's fd
sweep takes on the host (stage ``wide.coords.fd_sweep`` inside
``WideStream.ingest``: the launches of the reversed level loop, and
whatever they wait for), over the batches the profiler did not record.
Moves ``ordered_events_per_s``."""

from port_bench import stages


def read(run):
    calls = stages.window_calls(run, "wide.slice_batch")
    if calls is None:
        return None
    wall = sum(b["seconds"] for b, _ in calls)
    if wall <= 0:
        return None
    return sum(s["dur_s"] for _, roots in calls
               for s in stages.named(roots, "wide.coords.fd_sweep")) / wall
