"""HTTP /Stats + /metrics + /debug endpoints (service/service.go:26-58):
the port's copy of the JAX package's ``service/service.py``, with the
same routes, status codes and body keys.

A minimal asyncio HTTP server living in the node's event loop, returning
``node.get_stats()`` as JSON with the reference's stat-key schema.

Beyond the reference's flat string map, the node's telemetry registry
(``obs/``) is exposed machine-scrapably:

- ``/metrics``      — Prometheus text exposition (version 0.0.4) of the
  node's metric registry: counters, gauges, and the latency/size
  histograms behind the /Stats ``*_ms`` keys.  Read-only, same trust
  level as /Stats, so not loopback-gated.
- ``/healthz``      — the consensus-health verdict:
  minting blocked and why, probe/epoch state, round-advancement rate,
  quorum margin, commit-SLO burn, per-creator lag.  Host mirrors only;
  ungated like /metrics (``fleet health`` sweeps it remotely).
- ``/debug/spans``  — the span tracer's bounded ring as parent/child
  wall-clock trees (one tree per gossip/consensus/commit cycle), plus
  the drop counter so truncation is distinguishable from quiescence.
  Loopback-gated like the other /debug endpoints.
- ``/debug/lineage?tx=<sha256 hex>`` — this node's commit-lineage
  records for one tx plus the ledgers of every event they hash-join
  to (``fleet trace`` stitches the fleet's dumps).
- ``/debug/flight`` — the flight recorder's bounded ring of state
  transitions.

The reference piggy-backs Go pprof on the same listener (cmd/main.go:26,
``import _ "net/http/pprof"``); the equivalents here are the profilers
this runtime actually has:

- ``/debug/trace?seconds=S`` — capture a ``torch.profiler`` trace
  (host operators, and the card's kernels when the node runs on CUDA)
  of the next S seconds of live operation as a Chrome trace
  (``trace.json``, viewable in Perfetto or chrome://tracing), into a
  fresh private tempdir (returned in the response; the listener is
  unauthenticated, so no caller-chosen output paths).  The JAX package
  writes a JAX profiler trace here.
- ``/debug/profile?seconds=S``     — cProfile of the event-loop thread
  for S seconds, returned as pstats text (executor threads — the device
  dispatch path — need the trace above instead).
- ``/debug/stack``                 — instantaneous stack dump of every
  thread (the pprof goroutine-dump analogue; first stop for stalls).
"""

from __future__ import annotations

import asyncio
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ..common.aserver import AsyncTcpServer


#: trace tempdirs kept per service; older ones are deleted so repeated
#: /debug/trace calls cannot accumulate unbounded disk use
_MAX_TRACE_DIRS = 4

_trace_pool: Optional[ThreadPoolExecutor] = None


def _trace_executor() -> ThreadPoolExecutor:
    """The one thread that starts and stops trace sessions, created on
    first use."""
    global _trace_pool
    if _trace_pool is None:
        _trace_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="babble-trace"
        )
    return _trace_pool


class TraceSession:
    """One ``torch.profiler`` session, written as ``trace.json`` (Chrome
    trace format) into ``out_dir`` when it stops.  It records the card's
    activity too when the process has one."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._prof = prof

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))


class Service:
    def __init__(self, bind_addr: str, node, allow_remote_debug: bool = False):
        self.node = node
        self._server = AsyncTcpServer(bind_addr, self._handle)
        self._profiling = False
        # /debug can start profilers and dump internals; the stats listener
        # is unauthenticated, so by default only loopback callers get it
        self.allow_remote_debug = allow_remote_debug
        self._trace_dirs: list = []

    @property
    def bind_addr(self) -> str:
        return self._server.bind_addr

    async def start(self) -> None:
        await self._server.start()

    async def _debug(self, path: str, query: dict) -> tuple:
        try:
            seconds = float(query.get("seconds", ["2"])[0])
        except ValueError:
            seconds = float("nan")
        if not seconds == seconds:   # NaN (incl. unparsable input)
            return b"bad seconds parameter", "400 Bad Request", "text/plain"
        seconds = min(max(seconds, 0.1), 120.0)
        if path == "/debug/spans":
            tracer = getattr(self.node, "tracer", None)
            if tracer is None:
                return (b'{"error": "node has no span tracer"}',
                        "404 Not Found", "application/json")
            body = json.dumps({
                "capacity": tracer.capacity,
                "dropped": tracer.dropped,
                "trees": tracer.trees(),
            })
            return body.encode(), "200 OK", "application/json"
        if path == "/debug/lineage":
            # commit-lineage lookup: everything this node
            # recorded about one tx — its lifecycle records plus the
            # full ledgers of every event they hash-join to.  `fleet
            # trace` sweeps this across nodes and stitches one timeline.
            recorder = getattr(self.node, "lineage", None)
            if recorder is None:
                return (b'{"error": "node has no lineage recorder"}',
                        "404 Not Found", "application/json")
            txid = (query.get("tx", [""])[0] or "").strip().lower()
            if not txid:
                body = json.dumps({"stats": recorder.stats()})
                return body.encode(), "200 OK", "application/json"
            dump = recorder.lookup_tx(txid)
            dump["stats"] = recorder.stats()
            return (json.dumps(dump).encode(), "200 OK",
                    "application/json")
        if path == "/debug/flight":
            flight = getattr(self.node, "flight", None)
            if flight is None:
                return (b'{"error": "node has no flight recorder"}',
                        "404 Not Found", "application/json")
            body = json.dumps({
                "stats": flight.stats(),
                "records": flight.dump(),
            })
            return body.encode(), "200 OK", "application/json"
        if path == "/debug/stack":
            import sys
            import threading
            import traceback

            names = {t.ident: t.name for t in threading.enumerate()}
            lines = []
            for tid, frame in sys._current_frames().items():
                lines.append(f"Thread {names.get(tid, '?')} ({tid}):")
                lines.extend(traceback.format_stack(frame))
            return "\n".join(lines).encode(), "200 OK", "text/plain"
        if path == "/debug/profile":
            if self._profiling:
                return b"profiler already running", "409 Conflict", "text/plain"
            import cProfile
            import io
            import pstats

            self._profiling = True
            prof = cProfile.Profile()
            try:
                prof.enable()
                await asyncio.sleep(seconds)
            finally:
                # in the finally: a cancelled request must not leave the
                # global profiler tracing the event loop forever.  The
                # flag is a deliberate busy-guard (checked at entry with
                # no await before the set) — not an interleaving race.
                prof.disable()
                self._profiling = False  # babble-lint: disable=await-state-race
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(60)
            return buf.getvalue().encode(), "200 OK", "text/plain"
        if path == "/debug/trace":
            if self._profiling:
                return b"profiler already running", "409 Conflict", "text/plain"
            import tempfile

            # always a fresh private tempdir: the listener is
            # unauthenticated, so a caller-chosen path would be an
            # arbitrary-filesystem-write primitive
            out_dir = tempfile.mkdtemp(prefix="babble-trace-")
            self._trace_dirs.append(out_dir)
            while len(self._trace_dirs) > _MAX_TRACE_DIRS:
                import shutil

                shutil.rmtree(self._trace_dirs.pop(0), ignore_errors=True)
            self._profiling = True
            started = False
            loop = asyncio.get_running_loop()
            session = TraceSession(out_dir)
            # executor hop: profiler start/stop initialize the tracer
            # and serialize the trace, and running them inline stalls
            # the whole gossip loop for that long (the loop-lag probe's
            # exact failure mode).  One thread does both, so a session
            # stops on the thread that started it
            start_fut = loop.run_in_executor(_trace_executor(), session.start)
            try:
                # shield: if THIS handler is cancelled mid-start, the
                # worker thread still completes the start — the
                # cleanup below must know the session really started
                await asyncio.shield(start_fut)
                started = True
                await asyncio.sleep(seconds)
            finally:
                if started:
                    # only stop what actually started — a start failure
                    # must not mask itself with 'no trace running' and
                    # wedge _profiling permanently
                    await loop.run_in_executor(_trace_executor(), session.stop)
                else:
                    # cancelled while the start was in flight: stop the
                    # session the moment the worker thread finishes
                    # starting it, or it would record forever and wedge
                    # every later /debug/trace
                    start_fut.add_done_callback(
                        lambda f: (not f.cancelled()
                                   and f.exception() is None
                                   and _trace_executor().submit(session.stop))
                    )
                # same busy-guard pattern as /debug/profile above
                self._profiling = False  # babble-lint: disable=await-state-race
            body = json.dumps({"trace_dir": out_dir, "seconds": seconds})
            return body.encode(), "200 OK", "application/json"
        return b'{"error": "not found"}', "404 Not Found", "application/json"

    async def _handle(self, reader, writer) -> None:
        request_line = await reader.readline()
        parts = request_line.decode(errors="replace").split()
        raw_path = parts[1] if len(parts) >= 2 else "/"
        # drain headers
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        split = urlsplit(raw_path)
        path = split.path.rstrip("/") or "/stats"
        ctype = "application/json"
        if path.lower() == "/stats":
            body = json.dumps(self.node.get_stats()).encode()
            status = "200 OK"
        elif path == "/healthz":
            # consensus-health verdict: host mirrors
            # only, same trust level as /Stats — `fleet health`
            # aggregates it fleet-wide and flags divergence
            health = getattr(self.node, "healthz", None)
            if health is None:
                body = b'{"error": "node has no health surface"}'
                status = "404 Not Found"
            else:
                body = json.dumps(health()).encode()
                status = "200 OK"
        elif path == "/metrics":
            registry = getattr(self.node, "registry", None)
            if registry is None:
                body = b'{"error": "node has no metrics registry"}'
                status = "404 Not Found"
            else:
                body = registry.exposition().encode()
                status = "200 OK"
                ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path.startswith("/debug/"):
            peer = writer.get_extra_info("peername")
            peer_ip = peer[0] if peer else ""
            local = peer_ip in ("127.0.0.1", "::1", "::ffff:127.0.0.1")
            if local or self.allow_remote_debug:
                body, status, ctype = await self._debug(
                    path, parse_qs(split.query)
                )
            else:
                body = b'{"error": "debug endpoints are loopback-only"}'
                status = "403 Forbidden"
        else:
            body = b'{"error": "not found"}'
            status = "404 Not Found"
        writer.write(
            f"HTTP/1.1 {status}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body
        )
        await writer.drain()

    async def close(self) -> None:
        await self._server.close()
        import shutil

        while self._trace_dirs:
            shutil.rmtree(self._trace_dirs.pop(), ignore_errors=True)
