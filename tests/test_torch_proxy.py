"""The port's app proxies, admission control and HTTP service against the
JAX package's, through real loopback sockets, on the CPU.

- JSON-RPC crosses both ways (a port node-side proxy with a JAX app-side
  one and the reverse): ``SubmitTx``, ``SubmitTxBatch``, ``CommitTx``,
  ``CommitTxBatch``, the structured ``overloaded`` shed, and the bytes
  on the wire are the JAX pair's; the 16 MB object cap and invalid JSON
  end a stream in both, and an object longer than one read is read
  whole (the JAX reader refuses one cut inside a string), and a large
  call waits for its app's slow ack (the JAX client times out and the
  node's retry delivers the batch twice; both ROADMAP.md Queue 3), and a
  port node's retry of a late commit waits for its ack, not sending
  the batch again;
- admission control admits, sheds and drains alike on one seeded
  schedule of submits and drains under one fake monotonic clock, static
  and adaptive;
- the dummy app writes the JAX dummy's ``messages.txt`` bytes;
- the service answers every route with the JAX service's status,
  content type and body keys on a node of each package, gates /debug to
  loopback, and writes a ``torch.profiler`` trace on /debug/trace.

Bytes, texts and decisions are compared exactly; every wait is bounded.
"""

import asyncio
import json
import os
import random

import pytest

from babble_tpu.crypto import keys as jkeys
from babble_tpu.net import InmemNetwork as JNetwork
from babble_tpu.net import Peer as JPeer
from babble_tpu.node import Config as JConfig
from babble_tpu.node import Node as JNode
from babble_tpu.proxy import admission as jadm
from babble_tpu.proxy import dummy as jdummy
from babble_tpu.proxy import jsonrpc as jrpc
from babble_tpu.proxy.inmem import InmemAppProxy as JInmem
from babble_tpu.proxy.socket_app import SocketAppProxy as JSocketApp
from babble_tpu.proxy.socket_babble import SocketBabbleProxy as JSocketBabble
from babble_tpu.service import service as jservice

from babble_tpu_torch.crypto import keys as pkeys
from babble_tpu_torch.net import InmemNetwork, Peer
from babble_tpu_torch.node import Config, Node
from babble_tpu_torch.proxy import admission as padm
from babble_tpu_torch.proxy import dummy as pdummy
from babble_tpu_torch.proxy import jsonrpc as prpc
from babble_tpu_torch.proxy import InmemAppProxy
from babble_tpu_torch.proxy.socket_app import SocketAppProxy
from babble_tpu_torch.proxy.socket_babble import SocketBabbleProxy
from babble_tpu_torch.service import service as pservice

from .test_torch_net import _Tap

APP = {"jax": JSocketApp, "torch": SocketAppProxy}
BABBLE = {"jax": JSocketBabble, "torch": SocketBabbleProxy}
ADM = {"jax": jadm, "torch": padm}
COMBOS = [("jax", "jax"), ("jax", "torch"), ("torch", "jax"),
          ("torch", "torch")]


async def _proxy_pair(node_pkg, app_pkg, **caps):
    """A node-side proxy of ``node_pkg`` and an app-side one of
    ``app_pkg``, each reaching the other through a tap."""
    node = APP[node_pkg]("127.0.0.1:1", "127.0.0.1:0", **caps)
    await node.start()
    to_node = _Tap(node.bind_addr)
    app = BABBLE[app_pkg](await to_node.start(), "127.0.0.1:0")
    await app.start()
    to_app = _Tap(app.bind_addr)
    node.client.target = await to_app.start()
    return node, app, to_node, to_app


async def _close(node, app, *taps):
    await app.close()
    await node.close()
    for t in taps:
        await t.close()


def test_jsonrpc_crosses_both_ways_with_the_jax_bytes():
    async def run(node_pkg, app_pkg):
        node, app, to_node, to_app = await _proxy_pair(node_pkg, app_pkg)
        try:
            await app.submit_tx(b"the tx \x00\xff")
            got = [await asyncio.wait_for(node.submit_queue.get(), 5)]
            await app.client.call("Babble.SubmitTxBatch",
                                  [prpc.b64e(b"b1"), prpc.b64e(b"b2")])
            got += [node.submit_queue.get_nowait() for _ in range(2)]
            await node.commit_tx(b"committed \x01")
            await node.commit_batch([b"c1", b"c2", b""])
            commits = [app.commit_queue.get_nowait() for _ in range(4)]
        finally:
            await _close(node, app, to_node, to_app)
        return (bytes(to_node.c2s), bytes(to_node.s2c), bytes(to_app.c2s),
                bytes(to_app.s2c), got, commits)

    async def go():
        return {combo: await run(*combo) for combo in COMBOS}

    runs = asyncio.run(asyncio.wait_for(go(), 60))
    ref = runs["jax", "jax"]
    assert ref[4] == [b"the tx \x00\xff", b"b1", b"b2"]
    assert ref[5] == [b"committed \x01", b"c1", b"c2", b""]
    assert json.loads(ref[0].split(b"}", 1)[0] + b"}") == {
        "method": "Babble.SubmitTx", "params": [prpc.b64e(b"the tx \x00\xff")],
        "id": 1}
    for combo, run in runs.items():
        assert run == ref, combo


@pytest.mark.parametrize("node_pkg,app_pkg", [("jax", "torch"),
                                              ("torch", "jax")])
def test_overloaded_shed_crosses_as_the_typed_error(node_pkg, app_pkg):
    """A batch that trips the per-client cap mid-way: the client of the
    other package raises its own ``OverloadedError`` with the server's
    fields (``admitted`` says what to resubmit)."""

    async def go():
        node, app, to_node, to_app = await _proxy_pair(
            node_pkg, app_pkg, submit_per_client=3, submit_total=100)
        try:
            with pytest.raises(ADM[app_pkg].OverloadedError) as err:
                await app.client.call(
                    "Babble.SubmitTxBatch",
                    [prpc.b64e(b"t%d" % i) for i in range(5)])
            with pytest.raises(RuntimeError) as unknown:
                await app.client.call("Babble.Nope", None)
        finally:
            await _close(node, app, to_node, to_app)
        e = err.value
        assert (e.scope, e.depth, e.cap, e.retry_after_ms, e.admitted) == \
            ("client", 3, 3, 100, 3)
        assert str(unknown.value) == "unknown method Babble.Nope"
        assert node.submit_queue.qsize() == 3

    asyncio.run(asyncio.wait_for(go(), 60))


class _Reader:
    """A StreamReader stand-in serving fixed chunks, then EOF."""

    def __init__(self, chunks):
        self.chunks = list(chunks)

    async def read(self, n):
        return self.chunks.pop(0) if self.chunks else b""


@pytest.mark.parametrize("case", ["two_objects", "split", "invalid",
                                  "closed_invalid", "eof"])
def test_json_stream_reads_as_the_jax_one(case):
    assert prpc.MAX_OBJECT_BYTES == jrpc.MAX_OBJECT_BYTES == 16 << 20
    chunks = {
        "two_objects": [b'{"id": 1} {"id": 2}'],
        "split": [b'{"method": "A", ', b'"params": ["x"], "id": 3}'],
        "invalid": [b'{"id": 1} }{'],
        "closed_invalid": [b'{"id": 1} {"id": zz}'],
        "eof": [b'{"id": 1'],
    }[case]

    async def go():
        return (await _read_all(prpc, chunks),
                await _read_all(jrpc, chunks))

    got, want = asyncio.run(go())
    assert got == want
    if case in ("invalid", "closed_invalid"):
        assert got[-1][0] == "error"


async def _read_all(mod, chunks):
    stream = mod.JsonStream(_Reader(chunks))
    out = []
    while True:
        try:
            obj = await stream.next_obj()
        except mod.JsonStreamError as e:
            out.append(("error", str(e)))
            break
        out.append(obj)
        if obj is None:
            break
    return out


@pytest.mark.parametrize("cut", ["string", "literal", "escape"])
def test_json_stream_reads_an_object_cut_inside_a_token(cut):
    """A read that ends inside a string, a literal or an escape: the
    port waits for the rest and decodes the object; the JAX package's
    reader refuses the prefix (ROADMAP.md Queue 3: found in the
    reference, fixed in the port)."""
    obj = {"method": "State.CommitTxBatch", "params": [["abc", True]],
           "note": 'a"b', "id": 4}
    raw = json.dumps(obj).encode()
    at = {"string": raw.index(b"abc") + 1, "literal": raw.index(b"true") + 2,
          "escape": raw.index(b'\\"') + 1}[cut]
    chunks = [raw[:at], raw[at:]]

    async def go():
        return (await _read_all(prpc, chunks),
                await _read_all(jrpc, chunks))

    port, jax = asyncio.run(go())
    assert port == [obj, None]
    assert jax[0][0] == "error" and jax[0][1].startswith("invalid JSON")


def test_json_stream_refuses_an_open_object_past_the_cap():
    chunks = [b'{"p": "' + b"a" * (1 << 20)] * 17

    async def go():
        return await _read_all(prpc, chunks)

    assert asyncio.run(go()) == [("error", "JSON object exceeds size limit")]


def test_large_commit_batches_reach_the_port_dummy(tmp_path):
    """A node-side proxy of either package delivers a commit batch of
    3,000 transactions (about 270 KB of JSON, several reads) to the
    port's dummy app; the JAX dummy drops the connection on it."""
    txs = [(b"tx-%05d-" % i).ljust(64, b".") for i in range(3000)]

    async def deliver(node_pkg, dummy_mod, path):
        node = APP[node_pkg]("127.0.0.1:1", "127.0.0.1:0", timeout=10.0)
        await node.start()
        client = dummy_mod.DummySocketClient(node.bind_addr, "127.0.0.1:0",
                                             log_path=str(path))
        await client.start()
        node.client.target = client.proxy.bind_addr
        try:
            await node.commit_batch(txs)
            for _ in range(200):
                if len(client.state.get_messages()) == len(txs):
                    break
                await asyncio.sleep(0.02)
            return client.state.get_messages()
        except (ConnectionError, OSError) as e:
            return type(e).__name__
        finally:
            await client.close()
            await node.close()

    async def go():
        return [await deliver("jax", pdummy, tmp_path / "a.txt"),
                await deliver("torch", pdummy, tmp_path / "b.txt"),
                await deliver("torch", jdummy, tmp_path / "c.txt")]

    port_from_jax, port_from_port, jax_dummy = asyncio.run(
        asyncio.wait_for(go(), 60))
    want = [tx.decode() for tx in txs]
    assert port_from_jax == port_from_port == want
    assert (tmp_path / "a.txt").read_text().splitlines() == want
    assert jax_dummy in ("ConnectionError", "ConnectionResetError")


async def _slow_app(delay):
    """A JSON-RPC server that answers ``Slow`` after ``delay`` seconds
    and anything else at once, one request at a time per connection."""

    async def handle(reader, writer):
        stream = prpc.JsonStream(reader)
        while True:
            obj = await stream.next_obj()
            if obj is None:
                break
            if obj["method"] == "Slow":
                await asyncio.sleep(delay)
            result = "late" if obj["method"] == "Slow" else len(
                json.dumps(obj["params"]))
            writer.write(json.dumps({"id": obj["id"], "result": result,
                                     "error": None}).encode())
            await writer.drain()
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, "127.0.0.1:%d" % server.sockets[0].getsockname()[1]


def test_a_large_call_waits_for_its_slow_ack():
    """A 1.5 MB call whose ack comes after 0.5 s, on a client with a
    0.2 s timeout: the port waits one second a MiB of request and gets
    it; the JAX client times out (ROADMAP.md Queue 3: a commit batch
    that outlives it is delivered again)."""
    big = "x" * (3 << 19)

    async def go():
        server, addr = await _slow_app(0.5)
        out = {}
        for pkg, mod in (("torch", prpc), ("jax", jrpc)):
            client = mod.JsonRpcClient(addr, timeout=0.2)
            try:
                out[pkg] = await client.call("Slow", big)
            except asyncio.TimeoutError:
                out[pkg] = "timeout"
            await client.close()
        server.close()
        return out

    assert asyncio.run(asyncio.wait_for(go(), 30)) == {"torch": "late",
                                                       "jax": "timeout"}


def test_a_late_commit_ack_is_awaited_not_sent_again():
    """A port node whose app acks each commit batch 0.7 s after it came,
    behind a proxy that waits 0.2 s: the node's retries wait for the
    first call's ack on its connection, so the app gets each transaction
    once, in the fleet's order.  (A proxy that sends the batch again, as
    the JAX one does, hands the app each batch three or four times.)"""

    async def go():
        got = []

        async def commit_batch(txs):
            await asyncio.sleep(0.7)
            got.extend(prpc.b64d(t) for t in txs)
            return True

        app = prpc.JsonRpcServer("127.0.0.1:0")
        app.register("State.CommitTxBatch", commit_batch)
        await app.start()
        proxy = SocketAppProxy(app.bind_addr, "127.0.0.1:0", timeout=0.2)
        await proxy.start()
        net = InmemNetwork()
        keys = [pkeys.key_from_scalar(51 + i) for i in range(2)]
        ts = [net.transport() for _ in keys]
        peers = [Peer(t.local_addr(), k.pub_hex) for t, k in zip(ts, keys)]
        other = InmemAppProxy()
        nodes = [Node(Config.test_config(heartbeat=0.01, device="cpu"), k,
                      peers, t, p)
                 for k, t, p in zip(keys, ts, (proxy, other))]
        want = [b"late-%02d" % i for i in range(8)]
        try:
            for nd in nodes:
                nd.init()
                nd.run_task()
            for tx in want:
                await other.submit_tx(tx)
                await asyncio.sleep(0.05)
            while len(got) < len(want) or len(other.committed) < len(want):
                await asyncio.sleep(0.05)
            await asyncio.sleep(2.0)    # a batch sent again lands by now
            retries = nodes[0].registry.get(
                "babble_commit_retries_total").value
        finally:
            for nd in nodes:
                await nd.shutdown()
            await proxy.close()
            await app.close()
        return got, other.committed, retries

    got, order, retries = asyncio.run(asyncio.wait_for(go(), 90))
    assert retries >= 1
    assert sorted(got) == [b"late-%02d" % i for i in range(8)]
    assert got == order[:len(got)]


class _Clock:
    """One fake monotonic clock for both packages' admission modules."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.mark.parametrize("adaptive", [False, True])
def test_admission_decisions_equal_jax_on_one_schedule(adaptive,
                                                       monkeypatch):
    """The same seeded submit/drain/clock schedule through both packages'
    ``AdmissionQueue``s gives the same admit or shed decision (scope,
    depth, cap, admitted), the same drained transactions in the same
    round-robin order, and the same effective caps at every step."""
    clock = _Clock()
    for mod in (jadm, padm):
        monkeypatch.setattr(mod, "time", clock)
    queues = {pkg: ADM[pkg].AdmissionQueue(
        per_client=6, total=20, adaptive=adaptive, horizon_s=1.0,
        min_total=4, max_total=40) for pkg in ADM}
    rng = random.Random(31)
    logs = {pkg: [] for pkg in ADM}
    for step in range(1500):
        op = rng.random()
        client = f"c{rng.randrange(4)}"
        tx = b"tx-%d" % step
        dt = rng.choice((0.0, 0.01, 0.05, 0.2, 0.6))
        clock.t += dt
        for pkg, q in queues.items():
            if op < 0.55:
                try:
                    q.submit_nowait(client, tx)
                    logs[pkg].append(("admit", client))
                except ADM[pkg].OverloadedError as e:
                    logs[pkg].append(("shed", e.to_error()))
            elif op < 0.95:
                try:
                    logs[pkg].append(("drain", q.get_nowait()))
                except asyncio.QueueEmpty:
                    logs[pkg].append(("empty",))
            logs[pkg].append((q.qsize(), q.effective_total(),
                              q.effective_per_client()))
    assert logs["torch"] == logs["jax"]
    kinds = {e[0] for e in logs["torch"] if isinstance(e[0], str)}
    assert kinds == {"admit", "shed", "drain", "empty"}
    if adaptive:
        assert queues["torch"]._drain_ewma is not None
        assert queues["torch"]._drain_ewma == queues["jax"]._drain_ewma


def test_dummy_writes_the_jax_dummys_messages(tmp_path):
    """The same commits, one by one and in batches (invalid UTF-8
    included), give the same messages.txt bytes and messages."""
    txs = [b"hello world", "café".encode(), b"\xff\xfe bad", b""]

    async def run(mod, path):
        node = APP["jax"]("127.0.0.1:1", "127.0.0.1:0")
        await node.start()
        client = mod.DummySocketClient(node.bind_addr, "127.0.0.1:0",
                                       log_path=str(path))
        await client.start()
        node.client.target = client.proxy.bind_addr
        try:
            await client.submit_tx(b"from the app")
            got = await asyncio.wait_for(node.submit_queue.get(), 5)
            for tx in txs:
                await node.commit_tx(tx)
            await node.commit_batch(txs)
            for _ in range(100):
                if len(client.state.get_messages()) == 2 * len(txs):
                    break
                await asyncio.sleep(0.02)
            return got, client.state.get_messages()
        finally:
            await client.close()
            await node.close()

    async def go():
        return (await run(pdummy, tmp_path / "port.txt"),
                await run(jdummy, tmp_path / "jax.txt"))

    port, jax = asyncio.run(asyncio.wait_for(go(), 60))
    assert port == jax and port[0] == b"from the app"
    assert len(port[1]) == 2 * len(txs)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    st = pdummy.State(str(tmp_path / "s.txt"))
    st.commit_tx(b"x")
    assert st.get_messages() == ["x"]


# ----------------------------------------------------------------------
# the service


def _node(pkg):
    if pkg == "torch":
        key = pkeys.key_from_scalar(41)
        t = InmemNetwork().transport()
        node = Node(Config.test_config(device="cpu"), key,
                    [Peer(t.local_addr(), key.pub_hex)], t, InmemAppProxy())
    else:
        key = jkeys.key_from_scalar(41)
        t = JNetwork().transport()
        node = JNode(JConfig.test_config(), key,
                     [JPeer(t.local_addr(), key.pub_hex)], t, JInmem())
    node.init()
    return node


class _FakeReader:
    def __init__(self, request_line):
        self._lines = [request_line, b"Host: x\r\n", b"\r\n"]

    async def readline(self):
        return self._lines.pop(0) if self._lines else b""


class _FakeWriter:
    def __init__(self, peer):
        self._peer = peer
        self.data = b""

    def get_extra_info(self, key):
        return self._peer

    def write(self, b):
        self.data += b

    async def drain(self):
        pass


async def _request(svc, path, peer=("127.0.0.1", 40000)):
    w = _FakeWriter(peer)
    await svc._handle(_FakeReader(f"GET {path} HTTP/1.1\r\n".encode()), w)
    head, _, body = w.data.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    status = lines[0].split(b" ", 1)[1].decode()
    headers = dict(ln.decode().split(": ", 1) for ln in lines[1:])
    assert int(headers["Content-Length"]) == len(body)
    return status, headers["Content-Type"], body


ROUTES = ["/Stats", "/stats/", "/", "/metrics", "/healthz", "/debug/spans",
          "/debug/lineage", "/debug/lineage?tx=" + "ab" * 32,
          "/debug/flight", "/debug/stack", "/debug/profile?seconds=0.1",
          "/debug/profile?seconds=nan", "/debug/nothing", "/nothing"]


def _shape(body, ctype):
    """What a route's body must share across the packages: the keys of
    a JSON object (one level down for dicts), else its kind."""
    if ctype == "application/json":
        obj = json.loads(body)
        return {k: (sorted(v) if isinstance(v, dict) else type(v).__name__)
                for k, v in obj.items()}
    if ctype.startswith("text/plain; version=0.0.4"):
        return "prometheus"
    return "text"


def test_service_routes_equal_the_jax_services():
    async def go():
        out = {}
        for pkg, mod in (("jax", jservice), ("torch", pservice)):
            node = _node(pkg)
            svc = mod.Service("127.0.0.1:0", node)
            try:
                out[pkg] = {}
                for path in ROUTES:
                    status, ctype, body = await _request(svc, path)
                    out[pkg][path] = (status, ctype, _shape(body, ctype))
                status, ctype, body = await _request(
                    svc, "/debug/spans", peer=("10.1.2.3", 5555))
                out[pkg]["gated"] = (status, ctype, body)
                out[pkg]["families"] = sorted(
                    ln.split()[2] for ln in
                    node.registry.exposition().splitlines()
                    if ln.startswith("# TYPE"))
            finally:
                await svc.close()
                await node.shutdown()
        return out

    out = asyncio.run(asyncio.wait_for(go(), 120))
    assert out["torch"] == out["jax"]
    assert out["torch"]["gated"][0] == "403 Forbidden"
    assert out["torch"]["/debug/nothing"][0] == "404 Not Found"
    assert out["torch"]["/debug/profile?seconds=nan"][0] == "400 Bad Request"


def test_service_serves_over_a_socket():
    """/Stats and /metrics over a real connection on a port node."""
    import urllib.request

    async def go():
        node = _node("torch")
        svc = pservice.Service("127.0.0.1:0", node)
        await svc.start()
        loop = asyncio.get_running_loop()

        def get(path):
            url = f"http://{svc.bind_addr}{path}"
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.status, r.read()

        try:
            st, body = await loop.run_in_executor(None, get, "/Stats")
            stats = json.loads(body)
            st2, text = await loop.run_in_executor(None, get, "/metrics")
        finally:
            await svc.close()
            await node.shutdown()
        assert st == st2 == 200
        assert stats["consensus_events"] == "0" and "sync_rate" in stats
        assert b"babble_consensus_seconds_bucket" in text

    asyncio.run(asyncio.wait_for(go(), 60))


def test_testnet_fetchers_read_a_port_service():
    """``testnet.py``'s ``fetch_*`` helpers against a port node's service
    over a real connection: each returns its route's body, parsed."""
    from babble_tpu_torch import testnet as tn

    async def go():
        node = _node("torch")
        svc = pservice.Service("127.0.0.1:0", node)
        await svc.start()
        loop = asyncio.get_running_loop()
        addr = svc.bind_addr
        calls = [(tn.fetch_stats, addr), (tn.fetch_metrics, addr),
                 (tn.fetch_spans, addr), (tn.fetch_healthz, addr),
                 (tn.fetch_lineage, addr, "ab" * 32), (tn.fetch_flight, addr)]
        try:
            return [await loop.run_in_executor(None, *c) for c in calls]
        finally:
            await svc.close()
            await node.shutdown()

    stats, text, spans, health, lineage, flight = asyncio.run(
        asyncio.wait_for(go(), 60))
    assert stats["consensus_events"] == "0"
    assert "babble_consensus_seconds_bucket" in text
    for body in (spans, health, lineage, flight):
        assert isinstance(body, dict) and body
    assert tn.format_stats([stats]).splitlines()[2].startswith(stats["id"])


def test_debug_is_loopback_only_by_default():
    async def go():
        node = _node("torch")
        svc = pservice.Service("127.0.0.1:0", node)
        for path in ("/debug/stack", "/debug/spans", "/debug/trace"):
            status, _, body = await _request(svc, path,
                                             peer=("10.1.2.3", 5555))
            assert status == "403 Forbidden", path
            assert b"loopback" in body
        assert (await _request(svc, "/debug/stack", peer=None))[0] == \
            "403 Forbidden"
        for peer in (("127.0.0.1", 1), ("::1", 1, 0, 0),
                     ("::ffff:127.0.0.1", 1, 0, 0)):
            assert (await _request(svc, "/debug/stack", peer=peer))[0] == \
                "200 OK"
        assert (await _request(svc, "/metrics", peer=("10.1.2.3", 1)))[0] \
            == "200 OK"
        opened = pservice.Service("127.0.0.1:0", node,
                                  allow_remote_debug=True)
        assert (await _request(opened, "/debug/stack",
                               peer=("10.1.2.3", 1)))[0] == "200 OK"
        await node.shutdown()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_debug_trace_writes_a_torch_profiler_trace():
    """/debug/trace on the CPU: a Chrome trace in a private tempdir,
    the 409 guard while a capture runs, and the tempdir reaped on
    close."""

    async def go():
        node = _node("torch")
        svc = pservice.Service("127.0.0.1:0", node)
        try:
            first = asyncio.ensure_future(
                _request(svc, "/debug/trace?seconds=0.5"))
            await asyncio.sleep(0.2)
            busy = await _request(svc, "/debug/trace?seconds=0.1")
            status, ctype, body = await first
        finally:
            await node.shutdown()
        out = json.loads(body)
        path = os.path.join(out["trace_dir"], "trace.json")
        with open(path) as f:
            trace = json.load(f)
        assert os.path.basename(out["trace_dir"]).startswith("babble-trace-")
        await svc.close()
        return busy, status, ctype, out, trace, path

    busy, status, ctype, out, trace, path = asyncio.run(
        asyncio.wait_for(go(), 120))
    assert busy[:2] == ("409 Conflict", "text/plain")
    assert busy[2] == b"profiler already running"
    assert (status, ctype) == ("200 OK", "application/json")
    assert out["seconds"] == 0.5
    assert "traceEvents" in trace
    assert not os.path.exists(path)


def test_trace_tempdir_retention(monkeypatch):
    """Only the newest _MAX_TRACE_DIRS trace dirs survive, as in JAX."""
    assert pservice._MAX_TRACE_DIRS == jservice._MAX_TRACE_DIRS
    monkeypatch.setattr(pservice.TraceSession, "start", lambda self: None)
    monkeypatch.setattr(pservice.TraceSession, "stop", lambda self: None)

    async def go():
        node = _node("torch")
        svc = pservice.Service("127.0.0.1:0", node)
        dirs = []
        for _ in range(pservice._MAX_TRACE_DIRS + 3):
            status, _, body = await _request(svc, "/debug/trace?seconds=0.1")
            assert status == "200 OK"
            dirs.append(json.loads(body)["trace_dir"])
        keep = dirs[-pservice._MAX_TRACE_DIRS:]
        assert svc._trace_dirs == keep
        assert all(os.path.isdir(d) for d in keep)
        assert not any(os.path.exists(d) for d in dirs[:-len(keep)])
        await svc.close()
        assert not any(os.path.exists(d) for d in keep)
        await node.shutdown()

    asyncio.run(asyncio.wait_for(go(), 60))
