"""TCP transport (reference net/net_transport.go:61-395, tcp_transport.go):
the port's copy of the JAX package's ``net/tcp_transport.py``.  Its
frames are the JAX package's byte for byte, so nodes of both packages
read each other on one network.

The wire protocol is **multiplexed**: every
frame is tagged with a request id, so ONE pooled connection per target
carries any number of concurrent in-flight RPCs, responses returning in
whatever order the peer finishes them.  The reference (and the seed
port) ran sequential request/response lanes instead — ``max_pool=2``
connections each locked for a full round trip — which made gossip
lockstep: a slow sync parked the lane, and a heartbeat could never
overlap a Known exchange with event shipping.

Framing per request:  u8 type + u32 request id + u32 length + payload.
Responses:            u8 ok flag + u32 request id + u32 length +
                      (error string | msgpack payload).

Frame payloads are msgpack; encode/decode routes through the off-loop
codec (net/codec.py) so a big frame never stalls the event loop.  The
server side handles any number of interleaved RPCs per connection,
writing each response as its handler finishes (a fast sync is not
queued behind a slow snapshot).  ``FrameTooLarge`` is enforced
per-request-id on the serving side: the offending RPC gets an error
frame and the connection stays healthy for the others.
"""

from __future__ import annotations

import asyncio
import itertools
import struct
from typing import Dict, Optional, Tuple

from ..common.aserver import AsyncTcpServer
from .codec import decode_frame, encode_frame
from .commands import REQUEST_TYPES, RPC_FAST_FORWARD, SyncRequest, SyncResponse
from .transport import RPC, Transport, TransportError

_HDR = struct.Struct(">BII")    # type, request id, payload length
_RHDR = struct.Struct(">BII")   # ok flag, request id, payload length

# Inbound/outbound frame-size ceiling.  A u32 length would otherwise let a
# single malformed or hostile frame drive a 4 GiB readexactly allocation;
# the gossip port is at least as exposed as the JSON-RPC proxy (which caps
# at 16 MB, proxy/jsonrpc.py).  Sync/push payloads are event diffs — far
# below this in any honest configuration.
MAX_FRAME = 16 * 1024 * 1024
# fast-forward responses carry a whole compressed state window — allow
# them more than gossip frames, still bounded
MAX_FF_FRAME = 256 * 1024 * 1024


def _frame_cap(rtype: int) -> int:
    return MAX_FF_FRAME if rtype == RPC_FAST_FORWARD else MAX_FRAME


class FrameTooLarge(TransportError):
    pass


class _MuxConn:
    """One multiplexed client connection: a write half shared by all
    callers (each frame is a single ``write()`` — atomic on the loop —
    with ``drain`` serialized by a lock) and a reader task dispatching
    response frames to per-request-id futures."""

    def __init__(self, target: str, reader, writer, metrics, codec_obs):
        self.target = target
        self.reader = reader
        self.writer = writer
        self._metrics = metrics
        self._codec_obs = codec_obs
        self._ids = itertools.count(1)
        #: request id -> (future, rtype); popped on response/timeout
        self.pending: Dict[int, Tuple[asyncio.Future, int]] = {}
        self._wlock = asyncio.Lock()
        self.closed = False
        #: (rid, length, started_at) while the reader is mid-body on a
        #: large frame — lets a timed-out waiter distinguish "response
        #: in flight, just big" from "peer is gone" and extend its wait
        self.receiving: Optional[Tuple[int, int, float]] = None
        self._reader_task = asyncio.ensure_future(self._read_loop())

    async def call(self, req, timeout: float):
        if self.closed:
            raise TransportError(f"connection to {self.target} closed")
        loop = asyncio.get_running_loop()
        rid = next(self._ids)
        body = await encode_frame(req, self._codec_obs("encode"))
        if len(body) > _frame_cap(req.RTYPE):
            raise FrameTooLarge(
                f"{len(body)}-byte request exceeds the "
                f"{_frame_cap(req.RTYPE)}-byte frame cap"
            )
        fut = loop.create_future()
        self.pending[rid] = (fut, req.RTYPE)
        try:
            async with self._wlock:
                if self.closed:
                    raise TransportError(
                        f"connection to {self.target} closed"
                    )
                self.writer.write(_HDR.pack(req.RTYPE, rid, len(body)) + body)
                if self._metrics is not None:
                    self._metrics["bytes_out"].inc(_HDR.size + len(body))
                await self.writer.drain()
            while True:
                try:
                    return await asyncio.wait_for(
                        asyncio.shield(fut), timeout
                    )
                except asyncio.TimeoutError:
                    # Body-read budget scales with the in-flight frame:
                    # a legal 200 MB snapshot mid-download must not be
                    # killed by the sync timeout (floor ~1 MB/s).  ANY
                    # rid's big frame extends the wait, not just our
                    # own — frames share the one multiplexed stream, so
                    # a response queued behind a snapshot download is
                    # late, not lost, and erroring here would read a
                    # healthy peer as failed (head-of-line blocking the
                    # sequential lanes never had).  The budget is keyed
                    # to THAT frame's own start time, so a genuinely
                    # stalled stream still errors out.
                    rcv = self.receiving
                    if rcv is not None:
                        budget = max(rcv[1] / (1024 * 1024), 1.0)
                        if loop.time() - rcv[2] < budget:
                            continue
                    raise TransportError(
                        f"rpc to {self.target} timed out after {timeout}s"
                    ) from None
        finally:
            self.pending.pop(rid, None)

    async def _read_loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                hdr = await self.reader.readexactly(_RHDR.size)
                ok, rid, ln = _RHDR.unpack(hdr)
                entry = self.pending.get(rid)
                cap = _frame_cap(entry[1]) if entry else MAX_FF_FRAME
                if ln > cap:
                    # cannot skip ln bytes without allocating them: the
                    # stream is unusable — fail the affected waiter with
                    # the typed error, everyone else with a generic one
                    if entry is not None:
                        self.pending.pop(rid, None)
                        if not entry[0].done():
                            entry[0].set_exception(FrameTooLarge(
                                f"response frame of {ln} bytes exceeds "
                                f"{cap}"
                            ))
                    raise TransportError(
                        f"oversized response frame ({ln} bytes)"
                    )
                # single-writer publish: only this reader task writes
                # `receiving` (tuple swap, atomic on the loop); waiters
                # in call() only READ it to extend big-frame timeouts —
                # seeing either state is correct, so no lock is needed
                self.receiving = (rid, ln, loop.time())
                payload = await self.reader.readexactly(ln)
                self.receiving = None  # babble-lint: disable=await-state-race
                if self._metrics is not None:
                    self._metrics["bytes_in"].inc(_RHDR.size + ln)
                entry = self.pending.pop(rid, None)
                if entry is None:
                    continue        # waiter timed out and left: discard
                fut, rtype = entry
                if fut.done():
                    continue
                if ok != 0:
                    fut.set_exception(
                        TransportError(payload.decode(errors="replace"))
                    )
                    continue
                try:
                    resp = await decode_frame(
                        REQUEST_TYPES[rtype].RESPONSE_CLS, payload,
                        self._codec_obs("decode"),
                    )
                except Exception as e:
                    if not fut.done():
                        fut.set_exception(TransportError(
                            f"undecodable response from {self.target}: {e}"
                        ))
                    continue
                if not fut.done():
                    fut.set_result(resp)
        except asyncio.CancelledError:
            self._fail_pending("connection closed")
            raise
        except Exception as e:
            self._fail_pending(str(e) or type(e).__name__)
        finally:
            self.closed = True
            self.writer.close()

    def _fail_pending(self, why: str) -> None:
        self.closed = True
        for rid, (fut, _rtype) in list(self.pending.items()):
            if not fut.done():
                fut.set_exception(
                    TransportError(f"sync to {self.target} failed: {why}")
                )
        self.pending.clear()

    def close(self) -> None:
        self.closed = True
        self._reader_task.cancel()


class TCPTransport(Transport):
    def __init__(
        self,
        bind_addr: str,
        advertise: Optional[str] = None,
        max_pool: int = 2,
        timeout: float = 10.0,
    ):
        self.advertise = advertise or bind_addr
        host = self.advertise.split(":")[0]
        if host in ("", "0.0.0.0", "::"):
            raise ValueError(
                "advertise address must be a routable address, got "
                f"{self.advertise!r} (reference tcp_transport.go:51-57)"
            )
        #: legacy knob from the sequential-lane protocol; the
        #: multiplexed transport runs ONE connection per target that
        #: carries arbitrarily many concurrent RPCs, so extra lanes buy
        #: nothing.  Accepted (CLI compat) but unused.
        self.max_pool = max_pool
        self.timeout = timeout
        self._consumer: "asyncio.Queue[RPC]" = asyncio.Queue()
        self._server = AsyncTcpServer(bind_addr, self._handle_conn)
        self._conns: Dict[str, _MuxConn] = {}
        self._dialing: Dict[str, asyncio.Lock] = {}
        self._closed = False
        self._metrics: Optional[dict] = None
        self._codec_hist = None
        self._serve_tasks: set = set()

    def instrument(self, registry) -> None:
        """Attach a metrics registry (obs.Registry): wire-level byte
        counters, pool reuse-vs-dial, in-flight RPC gauge and codec
        stage latency.  Called by the owning Node so the transport's
        series land on the same /metrics page; without it the transport
        runs uninstrumented (in-memory test doubles)."""
        self._metrics = {
            "bytes_out": registry.counter(
                "babble_net_bytes_sent_total",
                "request/response payload bytes written to peers "
                "(frame headers included)"),
            "bytes_in": registry.counter(
                "babble_net_bytes_received_total",
                "request/response payload bytes read from peers "
                "(frame headers included)"),
            "pool_reuse": registry.counter(
                "babble_net_pool_reuse_total",
                "outbound RPCs served by the pooled multiplexed "
                "connection"),
            "pool_dial": registry.counter(
                "babble_net_pool_dial_total",
                "outbound RPCs that had to open a fresh connection"),
            # the port's own series: the caller reads this error frame's
            # empty text, so only this count tells it from another
            "serve_timeouts": registry.counter(
                "babble_net_serve_timeouts_total",
                "inbound RPCs whose handler outlived the timeout, each "
                "answered with an error frame of empty text"),
        }
        self._codec_hist = registry.histogram(
            "babble_codec_seconds",
            "wire encode/decode stage wall time (executor queueing "
            "included), by stage",
            labelnames=("stage",))
        for stage in ("encode", "decode"):
            self._codec_hist.labels(stage)
        registry.gauge(
            "babble_net_inflight_rpcs",
            "outbound RPCs awaiting a response across all peers",
        ).set_function(
            lambda: sum(len(c.pending) for c in self._conns.values())
        )

    def _codec_obs(self, stage: str):
        if self._codec_hist is None:
            return None
        return self._codec_hist.labels(stage).observe

    async def start(self) -> None:
        requested_port = self._server.bind_addr.rsplit(":", 1)[1]
        await self._server.start()
        if requested_port == "0":  # resolve to the actual bound port
            actual = self._server.bind_addr.rsplit(":", 1)[1]
            ahost = self.advertise.rsplit(":", 1)[0]
            self.advertise = f"{ahost}:{actual}"

    @property
    def bind_addr(self) -> str:
        return self._server.bind_addr

    @property
    def consumer(self) -> "asyncio.Queue[RPC]":
        return self._consumer

    def local_addr(self) -> str:
        return self.advertise

    # ------------------------------------------------------------------
    # server side

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """Read request frames and spawn one responder task per RPC:
        responses are written (under a per-connection lock) as their
        handlers finish, in any order — the request id routes each one
        back to the right waiter on the client."""
        wlock = asyncio.Lock()
        while not self._closed:
            try:
                hdr = await reader.readexactly(_HDR.size)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            rtype, rid, ln = _HDR.unpack(hdr)
            if ln > MAX_FRAME:
                # oversized request frame: close without allocating —
                # the stream can't be resynchronized anyway
                writer.close()
                return
            payload = await reader.readexactly(ln)
            m = self._metrics
            if m is not None:
                m["bytes_in"].inc(_HDR.size + ln)
            req_cls = REQUEST_TYPES.get(rtype)
            if req_cls is None:
                await self._write_frame(writer, wlock, 1, rid, b"")
                continue
            try:
                cmd = await decode_frame(
                    req_cls, payload, self._codec_obs("decode")
                )
            except Exception:
                # malformed payload: report an error frame and drop the
                # connection (protocol state is untrustworthy)
                await self._write_frame(
                    writer, wlock, 1, rid, b"malformed sync request"
                )
                writer.close()
                return
            rpc = RPC(command=cmd)
            await self._consumer.put(rpc)
            t = asyncio.ensure_future(
                self._serve_rpc(rpc, rtype, rid, writer, wlock)
            )
            self._serve_tasks.add(t)
            t.add_done_callback(self._serve_tasks.discard)

    async def _serve_rpc(self, rpc, rtype, rid, writer, wlock) -> None:
        """Await one RPC's handler and write its tagged response."""
        # snapshot serving (fast-forward) serializes a whole window
        # under the core lock — give it real time, unlike syncs
        wait = (self.timeout if rtype != RPC_FAST_FORWARD
                else max(self.timeout, 30.0))
        try:
            resp = await asyncio.wait_for(rpc.response(), wait)
            body = await encode_frame(resp, self._codec_obs("encode"))
            if len(body) > _frame_cap(rtype):
                raise FrameTooLarge(
                    f"{len(body)}-byte response exceeds the "
                    f"{_frame_cap(rtype)}-byte frame cap (shrink the "
                    f"window or raise the cap)"
                )
            await self._write_frame(writer, wlock, 0, rid, body)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # handler error -> error frame, per rid
            if (isinstance(e, asyncio.TimeoutError)
                    and self._metrics is not None):
                self._metrics["serve_timeouts"].inc()
            try:
                await self._write_frame(
                    writer, wlock, 1, rid, str(e).encode()[:4096]
                )
            except (ConnectionError, OSError):
                pass            # peer gone: nothing left to tell it

    async def _write_frame(self, writer, wlock, ok, rid, body) -> None:
        async with wlock:
            writer.write(_RHDR.pack(ok, rid, len(body)) + body)
            if self._metrics is not None:
                self._metrics["bytes_out"].inc(_RHDR.size + len(body))
            await writer.drain()

    # ------------------------------------------------------------------
    # client side

    async def _get_conn(self, target: str) -> _MuxConn:
        m = self._metrics
        conn = self._conns.get(target)
        if conn is not None and not conn.closed:
            if m is not None:
                m["pool_reuse"].inc()
            return conn
        # single-flight dial per target: concurrent RPCs during a dial
        # share the one connection instead of racing N opens
        lock = self._dialing.setdefault(target, asyncio.Lock())
        async with lock:
            conn = self._conns.get(target)
            if conn is not None and not conn.closed:
                if m is not None:
                    m["pool_reuse"].inc()
                return conn
            if m is not None:
                m["pool_dial"].inc()
            host, port = target.rsplit(":", 1)
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), self.timeout
            )
            conn = _MuxConn(target, reader, writer, m, self._codec_obs)
            self._conns[target] = conn
            return conn

    async def sync(
        self, target: str, req: SyncRequest, timeout: Optional[float] = None
    ) -> SyncResponse:
        return await self.request(target, req, timeout)

    async def request(self, target, req, timeout: Optional[float] = None):
        """Generic verb-tagged RPC (req.RTYPE / req.RESPONSE_CLS) over
        the target's multiplexed connection.  A timeout abandons only
        THIS request id — the connection (and every other in-flight
        RPC on it) stays healthy, unlike the sequential protocol where
        any failure poisoned the lane."""
        if self._closed:
            raise TransportError("transport closed")
        timeout = timeout or self.timeout
        try:
            conn = await self._get_conn(target)
            return await conn.call(req, timeout)
        except asyncio.TimeoutError as e:
            # dial timeout (call timeouts already raise TransportError);
            # caught first: asyncio.TimeoutError is TimeoutError, an
            # OSError, so the clause below would read it as an empty
            # "sync to X failed: "
            raise TransportError(f"dial to {target} timed out") from e
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            conn = self._conns.get(target)
            if conn is not None:
                conn.close()
                self._conns.pop(target, None)
            raise TransportError(f"sync to {target} failed: {e}") from e

    async def close(self) -> None:
        self._closed = True
        await self._server.close()
        for t in list(self._serve_tasks):
            t.cancel()
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()


async def new_tcp_transport(
    bind_addr: str, advertise: Optional[str] = None,
    max_pool: int = 2, timeout: float = 10.0,
) -> TCPTransport:
    t = TCPTransport(bind_addr, advertise, max_pool, timeout)
    await t.start()
    return t
