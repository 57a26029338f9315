"""Layer ``stream``: per batch the rounds, fame, order and compact
seconds that ``WideStream.timings`` adds; their 95th percentile over
the batches the profiler did not record, in ms.  Moves
``batch_latency_p95_ms``."""

from port_bench.spec import percentile

STAGES = ("rounds", "fame", "order", "compact")


def read(run):
    v = percentile([sum(b["stages"][s] for s in STAGES)
                    for b in run["batches"] if not b["profiled"]], 95)
    return None if v is None else v * 1e3
