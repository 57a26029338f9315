"""The program's stage spans, as the per-layer metrics read them: the
process-wide ring ``STAGES`` of ``babble_tpu_torch/obs/spans.py``, read
after the measured window and cut to the window's calls.

A call is the run of root spans that begins with the span that opens it
(``wide.slice_batch`` for a batch of the stream, ``fork.upload`` for a
call of the fork pipeline).  The newest calls are the window's, one per
record of ``run["batches"]``, aligned newest last.  Where the program
keeps no stage ring, or the ring dropped any span of the window's
calls, there is nothing to read.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def window_calls(run, first: str) -> Optional[List[Tuple[dict, list]]]:
    """``(batch record, root span trees)`` for each of the window's
    calls that the profiler did not record; None where there is nothing
    to read."""
    try:
        from babble_tpu_torch.obs import spans
    except ImportError:
        return None
    ring = getattr(spans, "STAGES", None)
    batches = run["batches"]
    if ring is None or not batches:
        return None
    calls: List[list] = []
    for t in ring.trees():
        if t["parent"] is not None:     # its parent fell off the ring
            continue
        if t["name"] == first:
            calls.append([t])
        elif calls:
            calls[-1].append(t)
    if len(calls) < len(batches):
        return None
    calls = calls[len(calls) - len(batches):]
    # span ids count up from each span's opening, and a call's first
    # root opens before everything after it: an id missing from there
    # on is a span of the window that the ring dropped
    ids = {s["id"] for s in ring.dump()}
    if not all(i in ids for i in range(calls[0][0]["id"], max(ids) + 1)):
        return None
    out = [(b, c) for b, c in zip(batches, calls) if not b["profiled"]]
    return out or None


def named(trees, name: str) -> List[dict]:
    """Every span called ``name`` in ``trees`` or below them."""
    out, todo = [], list(trees)
    while todo:
        t = todo.pop()
        if t["name"] == name:
            out.append(t)
        todo.extend(t["children"])
    return out


def host_s(roots) -> float:
    """The host's own seconds in ``roots``: their wall less the time
    they waited on the device (``read_wait_s`` covers a span's
    children)."""
    return sum(t["dur_s"] - t["attrs"]["read_wait_s"] for t in roots)
