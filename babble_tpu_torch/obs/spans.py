"""Span tracer: wall-clock trees for one consensus cycle.

The phase timers in /Stats say how long each phase took *on average*;
they cannot say where one slow round's time went.  Spans can: each
``with tracer.span("gossip"):`` records a (name, start, duration,
parent) tuple into a bounded ring buffer, and parent/child links are
carried by a ``contextvars.ContextVar`` — so nested spans inside one
asyncio task (submit → gossip → device step → commit) form a tree even
while many gossip tasks interleave on the same loop.

Boundaries of the design:

- **Bounded by construction.**  Completed spans land in a
  ``deque(maxlen=capacity)``; old spans fall off and are counted in
  ``dropped`` — a scraper can tell truncation from quiescence.
- **Threads report, tasks inherit.**  The ring append is
  lock-protected so worker threads may record spans, but context
  propagation is per-task: device work dispatched with
  ``run_in_executor`` is timed from the awaiting coroutine (the span
  wraps the await), or recorded after the fact with :meth:`record`
  using host-measured durations.
- **No clock games.**  ``start`` is epoch wall time (cross-node
  alignment in a fleet dump), ``dur_s`` is measured with
  ``perf_counter``.

Stages.  The device pipelines (``ops/stream.py``, ``ops/wide.py``,
``ops/forks.py``) and the live engine (``consensus/engine.py``,
``ops/flush.py``) time their own stages with :func:`stage`, which
records into the process-wide ring :data:`STAGES`, a tracer made with
``counters=True``.  A stage carries
counters: :func:`count` adds to the innermost open stage, and
:func:`host_read` (every device->host read and blocking copy the
pipelines make goes through it) adds one ``host_reads`` and the call's
blocking wall as ``read_wait_s`` to every open stage, so a stage's
``dur_s - read_wait_s`` is the host's own time in it.  While a
``torch.profiler`` records, and only then, a stage also opens
``torch.profiler.record_function(name)``: the span then shows in the
device trace as a ``user_annotation`` on the trace's own clock, and its
record says ``profiled``.  Torch is reached through ``sys.modules``, so
this module imports without it.
"""

from __future__ import annotations

import contextvars
import functools
import inspect
import itertools
import sys
import threading
import time
from collections import deque
from typing import List, Optional

#: capacity of the stage ring: a 51 s window holds at most ~300 calls
#: of the stream or the fork pipeline (~14 stages each), or ~850
#: flushes of the live engine (8 stages each, 11 where the latency
#: flush falls back), measured on an H100; this holds the engine's at
#: four times that rate with every flush falling back
STAGE_CAPACITY = 65536


class SpanTracer:
    """A ring of completed spans.  ``counters=True`` makes its spans
    stages (module docstring): each starts with ``host_reads``,
    ``read_wait_s`` and ``profiled`` in its attrs and opens a profiler
    annotation while a profiler records."""

    def __init__(self, capacity: int = 1024, counters: bool = False):
        self.capacity = capacity
        self.counters = counters
        self._done: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        #: the innermost open :class:`Span` of this task or thread
        self._current: contextvars.ContextVar = contextvars.ContextVar(
            "babble_span", default=None
        )
        self.dropped = 0

    # ------------------------------------------------------------------

    def span(self, name: str, **attrs) -> "Span":
        """``with tracer.span(name) as sp:`` records the enclosed block
        as a span; nested spans (same task) become children."""
        return Span(self, name, attrs)

    def record(self, name: str, duration_s: float, **attrs) -> None:
        """A completed span ending now, childed to the current span —
        for durations measured elsewhere (e.g. per-phase timings
        returned from a worker thread)."""
        up = self._current.get()
        self._finish(name, next(self._ids), None if up is None else up.sid,
                     time.time() - duration_s, duration_s, attrs, None)

    def traced(self, name: Optional[str] = None):
        """Decorator form of :meth:`span` for sync and async callables."""
        def deco(fn):
            label = name or fn.__qualname__
            if inspect.iscoroutinefunction(fn):
                @functools.wraps(fn)
                async def awrapper(*args, **kwargs):
                    with self.span(label):
                        return await fn(*args, **kwargs)
                return awrapper

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.span(label):
                    return fn(*args, **kwargs)
            return wrapper
        return deco

    def _finish(self, name, sid, parent, t_wall, dur_s, attrs, error):
        span = {
            "name": name,
            "id": sid,
            "parent": parent,
            "start": t_wall,
            "dur_s": dur_s,
        }
        if attrs:
            span["attrs"] = attrs
        if error is not None:
            span["error"] = error
        with self._lock:
            if len(self._done) == self.capacity:
                self.dropped += 1
            self._done.append(span)

    # ------------------------------------------------------------------

    def dump(self) -> List[dict]:
        """Completed spans, oldest first (bounded by ``capacity``)."""
        with self._lock:
            return [dict(s) for s in self._done]

    def trees(self) -> List[dict]:
        """Parent/child forest over the retained spans.  A span whose
        parent already fell off the ring surfaces as a root — partial
        trees beat silently vanishing ones."""
        spans = self.dump()
        nodes = {s["id"]: {**s, "children": []} for s in spans}
        roots = []
        for s in spans:
            node = nodes[s["id"]]
            parent = s["parent"]
            if parent is not None and parent in nodes:
                nodes[parent]["children"].append(node)
            else:
                roots.append(node)
        return roots

    def clear(self) -> None:
        with self._lock:
            self._done.clear()
            self.dropped = 0


def _annotation(name: str):
    """``torch.profiler.record_function(name)`` while a profiler
    records, else None (without torch loaded: None)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    return torch.profiler.record_function(name)


class Span:
    """One span of a tracer, open inside its ``with``: ``attrs`` are
    recorded at close (a stage's counters among them), ``dur_s`` once
    closed, ``up`` is the enclosing open span."""

    __slots__ = ("name", "attrs", "sid", "up", "dur_s", "_tracer",
                 "_token", "_rf", "_wall", "_t0")

    def __init__(self, tracer: SpanTracer, name: str, attrs: dict):
        self.name, self.attrs, self._tracer = name, attrs, tracer
        if tracer.counters:
            attrs.update(host_reads=0, read_wait_s=0.0, profiled=False)
        self.dur_s: Optional[float] = None

    def __enter__(self) -> "Span":
        tr = self._tracer
        self.up = tr._current.get()
        self.sid = next(tr._ids)
        self._token = tr._current.set(self)
        self._wall = time.time()
        self._t0 = time.perf_counter()
        self._rf = _annotation(self.name) if tr.counters else None
        if self._rf is not None:
            self.attrs["profiled"] = True
            self._rf.__enter__()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        self.dur_s = time.perf_counter() - self._t0
        tr = self._tracer
        tr._current.reset(self._token)
        tr._finish(self.name, self.sid,
                   None if self.up is None else self.up.sid, self._wall,
                   self.dur_s, self.attrs,
                   None if et is None else et.__name__)
        return False


#: the process-wide stage ring (module docstring)
STAGES = SpanTracer(capacity=STAGE_CAPACITY, counters=True)


def stage(name: str, **attrs) -> Span:
    """``with stage("wide.ingest") as st:`` times the block as a span of
    :data:`STAGES`, childed to the enclosing stage."""
    return STAGES.span(name, **attrs)


def count(key: str, k=1) -> None:
    """Add ``k`` to counter ``key`` of the innermost open stage (nothing
    outside a stage)."""
    st = STAGES._current.get()
    if st is not None:
        st.attrs[key] = st.attrs.get(key, 0) + k


def host_read(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call that blocks the host on the
    device (``t.item``, ``t.tolist``, ``t.cpu``, a synchronise, a copy
    from pageable memory), counted as one ``host_reads`` and its wall
    added to ``read_wait_s`` on every open stage."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        dt = time.perf_counter() - t0
        st = STAGES._current.get()
        while st is not None:
            st.attrs["host_reads"] += 1
            st.attrs["read_wait_s"] += dt
            st = st.up
