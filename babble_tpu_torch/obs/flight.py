"""Flight recorder: a bounded ring of structured state transitions.

Metrics say a counter moved; they cannot say in what ORDER the node
walked its state machine into the ground.  The flight recorder keeps
the last N structured transition records — epoch applied, eviction
horizon advanced, fast-forward attempted/rejected/adopted, seq probe
armed/resolved, admission shed episodes, kernel fallbacks, WAL
recovery verdicts — so a crash or a chaos invariant violation dumps a
readable last-N-transitions narrative per node instead of "seed 7
failed".

Design notes:

- **Bounded ring** (``deque(maxlen=...)``) with a drop counter, same
  discipline as the span tracer: truncation is visible, never silent.
- **Rate-limited notes** for kinds that can fire per-transaction
  (admission sheds, mint backpressure): ``note_limited`` coalesces an
  episode into one record per ``min_interval_s`` carrying the count it
  absorbed — a bombard burst must not evict the interesting records.
- **Wall + monotonic timestamps**, like spans/lineage: wall for
  cross-node alignment in a fleet dump, monotonic for exact in-node
  deltas.
- Stdlib-only; safe from the event loop and worker threads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List


class FlightRecorder:
    def __init__(self, capacity: int = 256, enabled: bool = True):
        self.capacity = capacity
        self.enabled = enabled
        self.boot = time.time()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.dropped = 0
        #: kind -> (last mono ts, coalesced count) for note_limited
        self._limited: Dict[str, list] = {}

    def note(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"kind": kind, "wall": time.time(),
               "mono": time.monotonic()}
        if fields:
            rec.update(fields)
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)

    def note_limited(self, kind: str, min_interval_s: float = 1.0,
                     **fields) -> None:
        """Coalescing note for per-transaction kinds: at most one ring
        record per ``min_interval_s``, carrying ``count`` = how many
        occurrences the record stands for."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            slot = self._limited.get(kind)
            if slot is not None and now - slot[0] < min_interval_s:
                slot[1] += 1
                return
            count = 1 + (slot[1] if slot is not None else 0)
            self._limited[kind] = [now, 0]
        self.note(kind, count=count, **fields)

    def dump(self) -> List[dict]:
        """Ring contents, oldest first, plus pending coalesced counts
        flushed as trailing records so an episode cut short by the dump
        still shows its tail."""
        with self._lock:
            out = [dict(r) for r in self._ring]
            pending = [(k, v[1]) for k, v in self._limited.items() if v[1]]
            for k, _c in pending:
                self._limited[k][1] = 0
        for kind, count in pending:
            out.append({"kind": kind, "wall": time.time(),
                        "mono": time.monotonic(), "count": count,
                        "coalesced_tail": True})
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"records": len(self._ring), "capacity": self.capacity,
                    "dropped": self.dropped, "enabled": self.enabled,
                    "boot": self.boot}


def format_dump(records: List[dict]) -> str:
    """Human rendering: one transition per line, relative seconds."""
    if not records:
        return "(flight recorder empty)"
    t0 = records[0]["wall"]
    lines = []
    for r in records:
        extra = " ".join(
            f"{k}={v}" for k, v in r.items()
            if k not in ("kind", "wall", "mono")
        )
        lines.append(f"  +{r['wall'] - t0:8.3f}s  {r['kind']:<20} {extra}")
    return "\n".join(lines)
