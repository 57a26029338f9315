"""Layer ``stream``: the share of the batches' wall that the wide
engine's coords stage takes (``WideStream.timings["coords"]`` added per
batch; the stage ends in a device synchronise), over the batches the
profiler did not record.  Moves ``ordered_events_per_s``."""


def read(run):
    bs = [b for b in run["batches"] if not b["profiled"]]
    wall = sum(b["seconds"] for b in bs)
    if wall <= 0:
        return None
    return sum(b["stages"]["coords"] for b in bs) / wall
