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
"""

from __future__ import annotations

import contextvars
import functools
import inspect
import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterator, List, Optional


class SpanTracer:
    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._done: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._current: contextvars.ContextVar = contextvars.ContextVar(
            "babble_span", default=None
        )
        self.dropped = 0

    # ------------------------------------------------------------------

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[int]:
        """Record the enclosed block as a span; nested spans (same task)
        become children."""
        parent = self._current.get()
        sid = next(self._ids)
        t_wall = time.time()
        t0 = time.perf_counter()
        token = self._current.set(sid)
        error: Optional[str] = None
        try:
            yield sid
        except BaseException as e:
            error = type(e).__name__
            raise
        finally:
            self._current.reset(token)
            self._finish(name, sid, parent, t_wall,
                         time.perf_counter() - t0, attrs, error)

    def record(self, name: str, duration_s: float, **attrs) -> None:
        """A completed span ending now, childed to the current span —
        for durations measured elsewhere (e.g. per-phase timings
        returned from a worker thread)."""
        self._finish(name, next(self._ids), self._current.get(),
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
