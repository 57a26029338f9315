"""The port's TCP transport and frame codec against the JAX package's,
through real loopback sockets, on the CPU.

- every command crosses between a JAX ``TCPTransport`` and a port one in
  both directions, and the bytes on the wire (seen by a tap between the
  two) are the very bytes two JAX transports exchange: request and
  response frames, error frames, and frames above the 64 KB codec gate;
- concurrent multiplexed RPCs each get their own response across the
  packages, answered out of order;
- the frame caps (per request id, oversized headers both ways, a request
  over the cap), a malformed frame, a big frame in flight that extends a
  waiter's budget, the timeout and unreachable texts, and advertise
  validation behave as ``tests/test_net.py`` holds the JAX transport to.

Bytes and texts are compared exactly; every wait is bounded.
"""

import asyncio
import struct

import pytest

from babble_tpu.net import codec as jcodec
from babble_tpu.net import tcp_transport as jtcp
from babble_tpu.net.transport import TransportError as JTransportError

from babble_tpu_torch.net import codec as pcodec
from babble_tpu_torch.net import tcp_transport as ptcp
from babble_tpu_torch.net.transport import TransportError

from .test_torch_wire import BIG, PKG, _commands, _fields

TCP = {"jax": jtcp, "torch": ptcp}
ERRORS = {"jax": JTransportError, "torch": TransportError}
COMBOS = [("jax", "jax"), ("jax", "torch"), ("torch", "jax"),
          ("torch", "torch")]


class _Tap:
    """A TCP forwarder that records the bytes of each direction."""

    def __init__(self, target: str):
        self.target = target
        self.c2s = bytearray()
        self.s2c = bytearray()
        self._server = None
        self._tasks = []

    async def start(self) -> str:
        self._server = await asyncio.start_server(self._conn, "127.0.0.1", 0)
        return "127.0.0.1:%d" % self._server.sockets[0].getsockname()[1]

    async def _conn(self, reader, writer):
        host, port = self.target.rsplit(":", 1)
        up_r, up_w = await asyncio.open_connection(host, int(port))

        async def pipe(src, dst, buf):
            try:
                while True:
                    chunk = await src.read(65536)
                    if not chunk:
                        break
                    buf += chunk
                    dst.write(chunk)
                    await dst.drain()
            except (ConnectionError, asyncio.CancelledError):
                pass
            finally:
                dst.close()

        self._tasks += [asyncio.ensure_future(pipe(reader, up_w, self.c2s)),
                        asyncio.ensure_future(pipe(up_r, writer, self.s2c))]

    async def close(self):
        self._server.close()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)


def _big_ff(pkg):
    """A fast-forward response of about 300 KB: past the codec gate on
    both sides of the wire."""
    c = PKG[pkg][0]
    snap = bytes(range(256)) * 1200
    return c.FastForwardResponse("inmem://3", snap, lcr=99, position=8192,
                                 digest="ab" * 32, sig_r=BIG, sig_s=7,
                                 epoch=1)


def _pair(pkg, req_name, resp_name):
    cmds = _commands(pkg)
    req = cmds[req_name]
    if resp_name == "ff_response_large":
        return req, _big_ff(pkg)
    return req, (None if resp_name == "error" else cmds[resp_name])


PAIRS = [
    ("sync_request", "sync_response"),
    ("sync_request", "sync_response_full"),
    ("sync_request", "sync_response_empty"),
    ("sync_request", "error"),
    ("ff_request", "ff_response"),
    ("ff_request", "ff_response_no_proof"),
    ("ff_request", "ff_response_large"),
    ("proof_request", "proof_response"),
    ("proof_request_anchor", "proof_response_anchor"),
    ("proof_request", "proof_response_unknown"),
    ("push_request", "push_response"),
    ("push_request_full", "push_response"),
]


async def _exchange(client_pkg, server_pkg, req_name, resp_name):
    """One RPC from a ``client_pkg`` transport to a ``server_pkg`` one
    through a tap: (request bytes, response bytes, what the server got,
    what the client got)."""
    server = await TCP[server_pkg].new_tcp_transport("127.0.0.1:0")
    client = await TCP[client_pkg].new_tcp_transport("127.0.0.1:0")
    tap = _Tap(server.local_addr())
    addr = await tap.start()
    req, _ = _pair(client_pkg, req_name, resp_name)
    _, resp = _pair(server_pkg, req_name, resp_name)
    got = {}

    async def serve():
        rpc = await server.consumer.get()
        got["req"] = rpc.command
        if resp is None:
            rpc.respond(None, "too_late: behind the window")
        else:
            rpc.respond(resp)

    t = asyncio.ensure_future(serve())
    try:
        try:
            out = await client.request(addr, req, timeout=10.0)
        except ERRORS[client_pkg] as e:
            out = e
        await asyncio.wait_for(t, 10)
        # the response frame is in the tap once the client has it
        return bytes(tap.c2s), bytes(tap.s2c), got["req"], out
    finally:
        await client.close()
        await server.close()
        await tap.close()


@pytest.mark.parametrize("req_name,resp_name", PAIRS)
def test_frames_equal_jax_in_both_directions(req_name, resp_name):
    """The request and response frames (headers, request ids, payloads,
    error texts) between any two packages are the JAX pair's bytes; the
    server reads an object of its own package that packs to the
    client's bytes, and the client reads the server's response so."""

    async def go():
        runs = {}
        for cp, sp in COMBOS:
            runs[cp, sp] = await _exchange(cp, sp, req_name, resp_name)
        ref_c2s, ref_s2c = runs["jax", "jax"][:2]
        assert len(ref_c2s) > jtcp._HDR.size and len(ref_s2c) >= jtcp._RHDR.size
        for (cp, sp), (c2s, s2c, got, out) in runs.items():
            assert c2s == ref_c2s, (cp, sp)
            assert s2c == ref_s2c, (cp, sp)
            req, _ = _pair(cp, req_name, resp_name)
            _, resp = _pair(sp, req_name, resp_name)
            assert type(got) is type(_pair(sp, req_name, resp_name)[0])
            assert got.pack() == req.pack()
            if resp is None:
                assert isinstance(out, ERRORS[cp])
                assert str(out) == "too_late: behind the window"
            else:
                assert type(out).__name__ == type(resp).__name__
                assert type(out).__module__.startswith(
                    "babble_tpu_torch" if cp == "torch" else "babble_tpu.")
                assert out.pack() == resp.pack()
                assert _fields(out) == _fields(resp)

    asyncio.run(asyncio.wait_for(go(), 60))


def test_codec_gate_and_thread_are_the_jax_packages():
    """One inline/offload threshold and one codec thread, as in JAX:
    small frames transcode on the loop, large ones on the codec thread,
    to the same bytes."""
    import threading

    assert pcodec.CODEC_OFFLOAD_BYTES == jcodec.CODEC_OFFLOAD_BYTES == 65536
    seen = []

    class Probe:
        def __init__(self, size):
            self.size = size

        def approx_size(self):
            return self.size

        def pack(self):
            seen.append(threading.current_thread().name)
            return b"x" * self.size

        @classmethod
        def unpack(cls, data):
            seen.append(threading.current_thread().name)
            return len(data)

    async def go():
        stages = []
        for size in (100, 70000):
            body = await pcodec.encode_frame(Probe(size), stages.append)
            assert body == b"x" * size
            assert await pcodec.decode_frame(Probe, body) == size
        assert len(stages) == 2
        return threading.current_thread().name

    loop_thread = asyncio.run(go())
    assert seen[:2] == [loop_thread, loop_thread]
    assert seen[2:] == ["babble-codec_0", "babble-codec_0"]
    assert pcodec.codec_executor() is pcodec.codec_executor()
    assert pcodec.codec_executor()._max_workers == 1


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "torch"),
                                                   ("torch", "jax")])
def test_concurrent_rpcs_never_cross_responses(client_pkg, server_pkg):
    """24 concurrent RPCs on one multiplexed connection, answered in
    reverse order by the other package, each get their own response."""

    async def go():
        a = await TCP[client_pkg].new_tcp_transport("127.0.0.1:0")
        b = await TCP[server_pkg].new_tcp_transport("127.0.0.1:0")
        creq = PKG[client_pkg][0].SyncRequest
        sresp = PKG[server_pkg][0].SyncResponse

        async def scrambling_server():
            held = [await b.consumer.get() for _ in range(24)]
            for rpc in reversed(held):
                rpc.respond(sresp(
                    from_addr=b.local_addr(),
                    head=repr(sorted(rpc.command.known.items())),
                    events=[]))

        t = asyncio.ensure_future(scrambling_server())

        async def one(i):
            resp = await a.sync(b.local_addr(),
                                creq(from_addr=a.local_addr(), known={0: i}),
                                timeout=10.0)
            assert resp.head == repr([(0, i)])

        await asyncio.gather(*(one(i) for i in range(24)))
        assert len(a._conns) == 1
        await t
        await a.close()
        await b.close()

    asyncio.run(asyncio.wait_for(go(), 60))


class _Huge:
    """Packs to more than MAX_FRAME bytes (the post-encode cap)."""

    def pack(self):
        return b"\x00" * (ptcp.MAX_FRAME + 1)

    def approx_size(self):
        return 0


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "torch"),
                                                   ("torch", "jax")])
def test_frame_cap_is_per_request_id(client_pkg, server_pkg):
    """A response over the cap is an error frame for that request id
    only: the connection keeps serving."""
    assert ptcp.MAX_FRAME == jtcp.MAX_FRAME == 16 * 1024 * 1024
    assert ptcp.MAX_FF_FRAME == jtcp.MAX_FF_FRAME == 256 * 1024 * 1024

    async def go():
        a = await TCP[client_pkg].new_tcp_transport("127.0.0.1:0")
        b = await TCP[server_pkg].new_tcp_transport("127.0.0.1:0")
        sresp = PKG[server_pkg][0].SyncResponse

        async def server():
            (await b.consumer.get()).respond(_Huge())
            (await b.consumer.get()).respond(
                sresp(from_addr=b.local_addr(), head="after", events=[]))

        t = asyncio.ensure_future(server())
        req = PKG[client_pkg][0].SyncRequest(from_addr=a.local_addr(),
                                             known={})
        with pytest.raises(ERRORS[client_pkg]) as err:
            await a.sync(b.local_addr(), req, timeout=10.0)
        assert str(err.value) == (
            f"{ptcp.MAX_FRAME + 1}-byte response exceeds the "
            f"{ptcp.MAX_FRAME}-byte frame cap (shrink the window or raise "
            "the cap)")
        conn = a._conns[b.local_addr()]
        assert not conn.closed
        resp = await a.sync(b.local_addr(), req, timeout=10.0)
        assert resp.head == "after" and a._conns[b.local_addr()] is conn
        await t
        await a.close()
        await b.close()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_request_over_the_cap_is_refused_before_it_is_sent():
    async def go():
        texts = {}
        for pkg in ("jax", "torch"):
            a = await TCP[pkg].new_tcp_transport("127.0.0.1:0")
            b = await TCP[pkg].new_tcp_transport("127.0.0.1:0")
            huge = PKG[pkg][0].SyncRequest(from_addr="x" * (1 << 24),
                                           known={})
            with pytest.raises(TCP[pkg].FrameTooLarge) as err:
                await a.sync(b.local_addr(), huge, timeout=10.0)
            texts[pkg] = str(err.value)
            assert b.consumer.empty()
            await a.close()
            await b.close()
        assert texts["torch"] == texts["jax"]
        assert "frame cap" in texts["torch"]

    asyncio.run(asyncio.wait_for(go(), 60))


def test_oversized_request_header_closes_the_connection():
    """A header claiming more than MAX_FRAME closes the connection
    without reading; the server keeps serving a JAX client."""

    async def go():
        b = await ptcp.new_tcp_transport("127.0.0.1:0")
        host, port = b.bind_addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(ptcp._HDR.pack(0, 1, ptcp.MAX_FRAME + 1))
        await writer.drain()
        assert await asyncio.wait_for(reader.read(1), 5.0) == b""
        writer.close()
        a = await jtcp.new_tcp_transport("127.0.0.1:0")
        sresp = PKG["torch"][0].SyncResponse

        async def serve_one():
            (await b.consumer.get()).respond(
                sresp(from_addr=b.local_addr(), head="h", events=[]))

        t = asyncio.ensure_future(serve_one())
        req = PKG["jax"][0].SyncRequest(from_addr=a.local_addr(), known={})
        assert (await a.sync(b.local_addr(), req)).head == "h"
        await t
        await a.close()
        await b.close()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_malformed_frame_gets_the_jax_error_frame_then_eof():
    """Garbage in a sync frame: both servers answer the same error frame
    (ok flag 1, the offending request id, the same text), then close;
    nothing reaches the consumer queue."""

    async def go():
        frames = {}
        junk = b"\xff\x00garbage-not-msgpack"
        for pkg in ("jax", "torch"):
            b = await TCP[pkg].new_tcp_transport("127.0.0.1:0")
            host, port = b.bind_addr.rsplit(":", 1)
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(ptcp._HDR.pack(0, 7, len(junk)) + junk)
            await writer.drain()
            frames[pkg] = await asyncio.wait_for(reader.read(1 << 16), 5.0)
            assert await asyncio.wait_for(reader.read(1), 5.0) == b""
            writer.close()
            assert b.consumer.empty()
            await b.close()
        assert frames["torch"] == frames["jax"]
        ok, rid, ln = ptcp._RHDR.unpack(frames["torch"][:ptcp._RHDR.size])
        assert (ok, rid) == (1, 7)
        assert frames["torch"][ptcp._RHDR.size:] == b"malformed sync request"

    asyncio.run(asyncio.wait_for(go(), 60))


async def _raw_server(handler):
    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    return server, "127.0.0.1:%d" % server.sockets[0].getsockname()[1]


def test_oversized_response_header_fails_the_waiter_and_the_stream():
    """A response header over the request's cap: the waiter gets the
    typed error and the connection is dropped, in both packages."""

    async def go():
        texts = {}
        for pkg in ("jax", "torch"):
            async def handler(reader, writer):
                hdr = await reader.readexactly(ptcp._HDR.size)
                _, rid, ln = ptcp._HDR.unpack(hdr)
                await reader.readexactly(ln)
                writer.write(ptcp._RHDR.pack(0, rid, ptcp.MAX_FRAME + 1))
                await writer.drain()

            server, addr = await _raw_server(handler)
            a = await TCP[pkg].new_tcp_transport("127.0.0.1:0")
            req = PKG[pkg][0].SyncRequest(from_addr=a.local_addr(), known={})
            with pytest.raises(TCP[pkg].FrameTooLarge) as err:
                await a.sync(addr, req, timeout=5.0)
            texts[pkg] = str(err.value)
            await asyncio.sleep(0.05)
            assert a._conns[addr].closed
            await a.close()
            server.close()
        assert texts["torch"] == texts["jax"] == (
            f"response frame of {ptcp.MAX_FRAME + 1} bytes exceeds "
            f"{ptcp.MAX_FRAME}")

    asyncio.run(asyncio.wait_for(go(), 60))


def test_big_frame_in_flight_extends_the_wait():
    """A 3 MB response whose body trickles in over about 1.5 s outlives a
    0.5 s timeout but not its budget (one second a MB, so 3 s): the
    waiter keeps waiting and gets it, in both packages."""

    async def go():
        snap = bytes(range(256)) * 12288
        body = PKG["torch"][0].FastForwardResponse("x", snap, lcr=3).pack()
        for pkg in ("jax", "torch"):
            async def handler(reader, writer):
                hdr = await reader.readexactly(ptcp._HDR.size)
                _, rid, ln = ptcp._HDR.unpack(hdr)
                await reader.readexactly(ln)
                writer.write(ptcp._RHDR.pack(0, rid, len(body)))
                step = len(body) // 10 + 1
                for i in range(0, len(body), step):
                    writer.write(body[i:i + step])
                    await writer.drain()
                    await asyncio.sleep(0.15)

            server, addr = await _raw_server(handler)
            a = await TCP[pkg].new_tcp_transport("127.0.0.1:0")
            req = PKG[pkg][0].FastForwardRequest(a.local_addr())
            t0 = asyncio.get_running_loop().time()
            resp = await a.request(addr, req, timeout=0.5)
            assert asyncio.get_running_loop().time() - t0 > 1.0
            assert resp.snapshot == snap and resp.lcr == 3, pkg
            await a.close()
            server.close()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_timeout_and_unreachable_texts_are_the_jax_packages():
    """The texts a node logs for a pull that timed out or found its peer
    gone, which the testnet's log check accepts by prefix."""

    async def go():
        texts = {}
        for pkg in ("jax", "torch"):
            writers = []

            async def silent(reader, writer):
                writers.append(writer)
                while await reader.read(1 << 16):
                    pass

            server, addr = await _raw_server(silent)
            a = await TCP[pkg].new_tcp_transport("127.0.0.1:0")
            req = PKG[pkg][0].SyncRequest(from_addr=a.local_addr(), known={})
            with pytest.raises(ERRORS[pkg]) as err:
                await a.sync(addr, req, timeout=0.2)
            timed_out = str(err.value)
            for w in writers:
                w.close()
            server.close()
            dead = await TCP[pkg].new_tcp_transport("127.0.0.1:0")
            gone = dead.local_addr()
            await dead.close()
            with pytest.raises(ERRORS[pkg]) as err:
                await a.sync(gone, req, timeout=0.2)
            refused = str(err.value)
            port = gone.rsplit(":", 1)[1]
            texts[pkg] = (timed_out.replace(addr, "X"),
                          refused.replace(gone, "X").replace(port, "P"))
            await a.close()
        assert texts["torch"] == texts["jax"]
        assert texts["torch"][0] == "rpc to X timed out after 0.2s"
        assert texts["torch"][1].startswith("sync to X failed: ")

    asyncio.run(asyncio.wait_for(go(), 60))


def test_a_dial_timeout_reads_as_a_timeout(monkeypatch):
    """A dial that outlives the transport's timeout is a timeout, which
    the testnet's log check counts for any peer.  The JAX transport's
    dial-timeout clause comes after its OSError clause, and
    asyncio.TimeoutError is an OSError, so JAX reports it as an
    unreachable peer with an empty reason."""

    async def never(*_args, **_kw):
        await asyncio.sleep(3600)

    async def go():
        texts = {}
        for pkg in ("jax", "torch"):
            a = await TCP[pkg].new_tcp_transport("127.0.0.1:0", timeout=0.1)
            req = PKG[pkg][0].SyncRequest(from_addr=a.local_addr(), known={})
            with monkeypatch.context() as m:
                m.setattr(asyncio, "open_connection", never)
                with pytest.raises(ERRORS[pkg]) as err:
                    await a.sync("127.0.0.1:9", req)
            texts[pkg] = str(err.value)
            await a.close()
        return texts

    texts = asyncio.run(asyncio.wait_for(go(), 30))
    assert texts["torch"] == "dial to 127.0.0.1:9 timed out"
    assert texts["jax"] == "sync to 127.0.0.1:9 failed: "


def test_advertise_validation_is_the_jax_packages():
    for addr in ("0.0.0.0:1337", ":1337"):
        with pytest.raises(ValueError) as pe:
            ptcp.TCPTransport(addr)
        with pytest.raises(ValueError) as je:
            jtcp.TCPTransport(addr)
        assert str(pe.value) == str(je.value)
    t = ptcp.TCPTransport("0.0.0.0:1337", advertise="10.0.0.5:1337")
    assert t.local_addr() == "10.0.0.5:1337"
    assert struct.calcsize(">BII") == ptcp._HDR.size == ptcp._RHDR.size


def test_a_handler_past_its_timeout_answers_an_empty_error_frame():
    """A server whose handler outlives its transport's timeout answers an
    error frame carrying asyncio's empty ``TimeoutError`` text, in both
    packages, byte for byte: a node logs that pull as ``gossip to X
    failed: `` (the testnet's log check counts it as the peer's own
    timeout)."""

    async def go():
        out = {}
        for cp, sp in COMBOS:
            server = await TCP[sp].new_tcp_transport("127.0.0.1:0",
                                                     timeout=0.2)
            client = await TCP[cp].new_tcp_transport("127.0.0.1:0")
            tap = _Tap(server.local_addr())
            addr = await tap.start()
            req = PKG[cp][0].SyncRequest(from_addr="x", known={0: 1})
            with pytest.raises(ERRORS[cp]) as err:
                await client.sync(addr, req, timeout=5.0)
            # the server's wait for its handler ran out and let go
            assert (await server.consumer.get())._future.cancelled()
            out[cp, sp] = (str(err.value), bytes(tap.s2c))
            await client.close()
            await server.close()
            await tap.close()
        return out

    out = asyncio.run(asyncio.wait_for(go(), 60))
    ok, rid, ln = ptcp._RHDR.unpack(out["jax", "jax"][1])
    assert (ok, rid, ln) == (1, 1, 0)
    assert all(v == ("", out["jax", "jax"][1]) for v in out.values()), out


def test_serve_timeouts_count_only_handler_timeouts():
    """The port's ``babble_net_serve_timeouts_total`` counts a handler
    that outlived the timeout and not the other empty error frame, the
    answer to an unknown request type: the testnet's log check holds a
    caller's empty-text pulls to this count."""
    from babble_tpu_torch.obs.metrics import Registry

    async def go():
        registry = Registry()
        server = await ptcp.new_tcp_transport("127.0.0.1:0", timeout=0.2)
        server.instrument(registry)
        client = await ptcp.new_tcp_transport("127.0.0.1:0")
        counter = registry.get("babble_net_serve_timeouts_total")
        host, port = server.local_addr().rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(ptcp._HDR.pack(99, 7, 0))
        answer = await reader.readexactly(ptcp._RHDR.size)
        writer.close()
        unknown = (ptcp._RHDR.unpack(answer), counter.value)
        req = PKG["torch"][0].SyncRequest(from_addr="x", known={0: 1})
        with pytest.raises(TransportError) as err:
            await client.sync(server.local_addr(), req, timeout=5.0)
        await client.close()
        await server.close()
        return unknown, str(err.value), counter.value

    unknown, text, count = asyncio.run(asyncio.wait_for(go(), 30))
    assert unknown == ((1, 7, 0), 0)
    assert (text, count) == ("", 1)


def test_the_testnet_log_check_reads_the_transports_texts():
    """``chip_smoke.py``'s phase 9 log check, fed the texts the port's
    transport really gives: a refused dial, an end of stream or a write
    that finds its connection lost counts as unreachable only for a peer
    inside one of its down spans; a protocol
    fault (an oversized frame) and any such text outside the spans fail;
    an empty text counts as the peer's own timeout only up to the
    handler timeouts that peer counted."""
    import socket
    import time

    import chip_smoke

    async def texts():
        req = PKG["torch"][0].SyncRequest(from_addr="x", known={0: 1})
        client = await ptcp.new_tcp_transport("127.0.0.1:0")

        async def pull(addr):
            try:
                await client.sync(addr, req, timeout=5.0)
            except TransportError as e:
                return str(e)

        server = await ptcp.new_tcp_transport("127.0.0.1:0", timeout=30)
        gone = asyncio.ensure_future(pull(server.local_addr()))
        await asyncio.sleep(0.2)
        await server.close()
        eof = await gone
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            closed = "127.0.0.1:%d" % s.getsockname()[1]
        refused = await pull(closed)

        async def oversized(reader, writer):
            for _ in range(2):
                _, rid, ln = ptcp._HDR.unpack(
                    await reader.readexactly(ptcp._HDR.size))
                await reader.readexactly(ln)
            writer.write(ptcp._RHDR.pack(0, rid, ptcp.MAX_FRAME + 1))
            await writer.drain()

        bad = await asyncio.start_server(oversized, "127.0.0.1", 0)
        bad_addr = "127.0.0.1:%d" % bad.sockets[0].getsockname()[1]
        faults = await asyncio.gather(pull(bad_addr), pull(bad_addr))
        bad.close()

        # a pull whose write finds its pooled connection already lost,
        # before the connection's reader has seen it go
        held = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
        lost_addr = "127.0.0.1:%d" % held.sockets[0].getsockname()[1]
        conn = await client._get_conn(lost_addr)
        conn.writer.transport.abort()
        lost = await pull(lost_addr)
        held.close()
        await client.close()
        return (server.local_addr(), eof, closed, refused, bad_addr, faults,
                lost_addr, lost)

    (down, eof, closed, refused, bad_addr, faults, lost_addr,
     lost) = asyncio.run(asyncio.wait_for(texts(), 30))
    assert eof.startswith(f"sync to {down} failed: ")
    assert refused.startswith(f"sync to {closed} failed: ")
    assert lost == f"sync to {lost_addr} failed: Connection lost"
    assert any("oversized response frame" in f for f in faults), faults

    t0 = time.time()
    stamp = (lambda at: time.strftime("%Y-%m-%d %H:%M:%S",
                                      time.localtime(at))
             + ",%03d" % int(at % 1 * 1000))

    def line(at, target, text):
        return (f"{stamp(at)} WARNING babble_tpu_torch gossip to {target} "
                f"failed: {text}")

    spans = {down: [(t0, t0 + 10)], closed: [(t0, t0 + 10)],
             lost_addr: [(t0, t0 + 10)]}
    ok = [line(t0 + 1, down, eof), line(t0 + 2, closed, refused),
          line(t0 + 2, lost_addr, lost),
          line(t0 + 3, "127.0.0.1:1", ""), line(t0 + 3, "127.0.0.1:1", ""),
          line(t0 + 4, down, f"rpc to {down} timed out after 0.2s")]
    check = chip_smoke.NodeLogCheck(spans)
    check.read(0, "\n".join(ok))
    check.check_peer_timeouts({"127.0.0.1:1": 2})
    assert check.failures == []
    assert check.kinds == {"pull unreachable": 3, "pull timeout (peer)": 2,
                           "pull timeout": 1}
    assert check.gone == {(down, "end of stream"): 1,
                          (closed, "refused"): 1, (lost_addr, "reset"): 1}

    bad = [line(t0 + 60, down, eof),                 # after the span
           line(t0 - 5, closed, refused),            # before it
           line(t0 + 20, lost_addr, lost),           # after its span
           line(t0 + 1, "127.0.0.1:2", refused.replace(closed,
                                                       "127.0.0.1:2")),
           *(line(t0 + 1, bad_addr, f) for f in faults)]
    spans[bad_addr] = [(t0, t0 + 10)]
    check = chip_smoke.NodeLogCheck(spans)
    check.read(0, "\n".join(bad + ok[3:5]))
    check.check_peer_timeouts({"127.0.0.1:1": 1})
    assert len(check.failures) == len(bad) + 1, check.failures
