"""End to end: the 95th percentile, over every batch of the window, of
the time from handing a batch to the stream until its ordering
decisions are on the host (host clock; ``consensus`` ends in a device
read)."""

from port_bench.spec import percentile


def read(run):
    v = percentile([b["latency_s"] for b in run["batches"]], 95)
    return None if v is None else v * 1e3
