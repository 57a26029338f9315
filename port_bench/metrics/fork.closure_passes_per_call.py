"""Layer ``fork pipeline``: the closure's passes a ``fork_pipeline``
call, averaged over the window's calls (``stats["closure_passes"]``, a
count the program keeps).  Moves ``ordered_events_per_s``."""


def read(run):
    calls = [b["closure_passes"] for b in run["batches"]
             if "closure_passes" in b]
    return sum(calls) / len(calls) if calls else None
