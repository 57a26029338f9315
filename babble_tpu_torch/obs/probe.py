"""Asyncio event-loop lag probe.

The gossip loop's worst failure mode is invisible in phase timers: some
call blocks the event loop itself (a sync syscall, a long host-side
numpy pass under the core lock), and *every* deadline — heartbeats,
timeouts, commit delivery — silently stretches.  The probe measures
exactly that: it sleeps ``interval`` and records how late the loop
woke it.  Sustained lag above a few ms at a 10 ms heartbeat is the
smoking gun for "the loop is starved", attributable before any
throughput number moves.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .metrics import Registry


class LoopLagProbe:
    def __init__(self, registry: Registry, interval: float = 0.5):
        self.interval = interval
        self._hist = registry.histogram(
            "babble_event_loop_lag_seconds",
            "scheduling delay of a timed sleep vs its deadline "
            "(sustained lag = the event loop is starved)",
        )
        self._task: Optional[asyncio.Task] = None

    def start(self) -> asyncio.Task:
        """Start the probe on the running loop (idempotent)."""
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run()
            )
        return self._task

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            self._hist.observe(max(0.0, loop.time() - t0 - self.interval))

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
