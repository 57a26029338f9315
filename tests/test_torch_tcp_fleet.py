"""Nodes of both packages in one fleet over loopback TCP, on the CPU.

Each node has its own package's ``TCPTransport`` and reads the other
package's frames off the socket, with no bridge:

- two JAX and two port ``Node``s (``Config.test_config``, 10 ms
  heartbeat) in one event loop commit every submitted transaction, each
  once, in one order;
- a port node behind a ``SocketAppProxy`` delivers its fleet's order to
  a dummy client over JSON-RPC, and takes the client's submissions.

What a node logs and carries on from is sorted by the TCP transport's
texts: a pull or push that timed out (``rpc to X timed out``, ``dial to
X timed out``, or the empty text of the peer's own error frame when its
handler outlived ``tcp_timeout``), found its peer gone (``sync to X
failed``, ``connection to X closed``) or behind the window, and a
fast-forward's notices, are counted; anything else fails the test.  Outcomes are asserted, never
schedules; every wait is bounded.  (Fast-forward over TCP across the
packages is ``tests/test_torch_tcp_fastforward.py``.)
"""

import asyncio
import logging

from babble_tpu.common import TooLateError as JTooLateError
from babble_tpu.crypto import keys as jkeys
from babble_tpu.net import Peer as JPeer
from babble_tpu.net.tcp_transport import new_tcp_transport as jnew_tcp
from babble_tpu.node import Config as JConfig
from babble_tpu.node import Node as JNode
from babble_tpu.proxy.inmem import InmemAppProxy as JProxy

from babble_tpu_torch.common import TooLateError
from babble_tpu_torch.crypto import keys as pkeys
from babble_tpu_torch.net import Peer, new_tcp_transport
from babble_tpu_torch.node import Config, Node
from babble_tpu_torch.proxy import InmemAppProxy
from babble_tpu_torch.proxy.dummy import DummySocketClient
from babble_tpu_torch.proxy.socket_app import SocketAppProxy
from babble_tpu_torch.sim.replay import replay_scalars

CPU = "cpu"
NEW_TCP = {"jax": jnew_tcp, "torch": new_tcp_transport}


class TcpFailures(logging.Handler):
    """Sorts what nodes log and carry on from.  A failed pull or push is
    read by the TCP transport's text (see the module docstring), or as
    ``too late`` when the pusher's own diff found the peer behind its
    window (``TooLateError``) or the peer answered ``too_late``; the
    notices of a fast-forward (adopted, refused, or failed and retried
    later) are counted; anything else a node logs at WARNING or above
    is a failure."""

    EXCHANGES = ("gossip to %s failed: %s", "push to %s failed: %s")
    CLASSES = (("rpc to ", "timeout"), ("dial to ", "timeout"),
               ("sync to ", "unreachable"), ("connection to ", "unreachable"),
               ("too_late", "too late"))
    NOTICES = ("fast-forwarded from ", "fast-forward snapshot from ",
               "fast-forward from ")
    TOO_LATE = (JTooLateError, TooLateError)

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []
        self.exchanges = {}

    def count(self, kind):
        self.exchanges[kind] = self.exchanges.get(kind, 0) + 1

    def emit(self, record):
        if record.msg in self.EXCHANGES:
            e = record.args[-1]
            cls = ("too late" if isinstance(e, self.TOO_LATE) else
                   "timeout" if str(e) == "" else
                   next((c for p, c in self.CLASSES
                         if str(e).startswith(p)), None))
            if cls is None:
                self.records.append(record.getMessage())
            else:
                self.count(f"{record.msg.split()[0]} {cls}")
        elif record.levelno >= logging.WARNING:
            msg = record.getMessage()
            notice = next((m for m in self.NOTICES if msg.startswith(m)),
                          None)
            if notice is None:
                self.records.append(msg)
            else:
                self.count(notice.strip())


def _conf(kind, **kw):
    if kind == "torch":
        c = Config.test_config(heartbeat=0.01, device=CPU)
    else:
        c = JConfig.test_config(heartbeat=0.01)
    for k, v in kw.items():
        setattr(c, k, v)
    return c


async def _fleet(kinds, seed, proxies=None, **conf_kw):
    """Nodes of ``kinds`` on TCP transports bound to free loopback ports;
    identities sorted by key, so node i is participant i."""
    scalars = replay_scalars(len(kinds), seed)
    ts = [await NEW_TCP[k]("127.0.0.1:0") for k in kinds]
    peers = [Peer(t.local_addr(), pkeys.key_from_scalar(d).pub_hex)
             for t, d in zip(ts, scalars)]
    if proxies is None:
        proxies = [InmemAppProxy() if k == "torch" else JProxy()
                   for k in kinds]
    failures = TcpFailures()
    nodes = [_node(k, _conf(k, **conf_kw), scalars[i], peers, ts[i],
                   proxies[i], failures) for i, k in enumerate(kinds)]
    return nodes, proxies, failures, peers


def _node(kind, conf, scalar, peers, transport, proxy, failures):
    conf.logger.addHandler(failures)
    conf.logger.setLevel(logging.DEBUG)     # a failed push is a DEBUG line
    if kind == "torch":
        return Node(conf, pkeys.key_from_scalar(scalar), peers, transport,
                    proxy)
    return JNode(conf, jkeys.key_from_scalar(scalar),
                 [JPeer(p.net_addr, p.pub_key_hex) for p in peers],
                 transport, proxy)


async def _until(pred, timeout, every=0.05):
    async def poll():
        while not pred():
            await asyncio.sleep(every)
    await asyncio.wait_for(poll(), timeout)


async def _shutdown(nodes, failures):
    for nd in nodes:
        await nd.shutdown()             # closes the transport too
        nd.conf.logger.removeHandler(failures)
        nd.conf.logger.setLevel(logging.WARNING)


def test_mixed_tcp_fleet_commits_every_transaction_in_one_order():
    async def go():
        nodes, proxies, failures, _ = await _fleet(
            ["jax", "torch", "jax", "torch"], seed=31)
        n_txs = 40
        try:
            for nd in nodes:
                nd.init()
                nd.run_task()
            for i in range(n_txs):
                await proxies[i % 4].submit_tx(b"tcp-%03d" % i)
            await _until(lambda: all(len(p.committed) >= n_txs
                                     for p in proxies), 120)
        finally:
            await _shutdown(nodes, failures)
        want = {b"tcp-%03d" % i for i in range(n_txs)}
        base = proxies[0].committed_transactions()
        for p in proxies:
            got = p.committed_transactions()
            assert set(got) >= want and len(got) == len(set(got))
            k = min(len(got), len(base))
            assert got[:k] == base[:k]
        lists = [nd.core.hg.consensus_events() for nd in nodes]
        k = min(len(x) for x in lists)
        assert k > 0 and all(x[:k] == lists[0][:k] for x in lists)
        assert all(nd.core.insert_failures == 0 for nd in nodes)
        assert failures.records == []
        # every node pulled from and served the other package
        for nd in nodes:
            assert nd.sync_requests > 0

    asyncio.run(asyncio.wait_for(go(), 180))


def test_port_node_behind_a_socket_proxy_delivers_to_a_dummy(tmp_path):
    """A port node with a ``SocketAppProxy`` in a fleet with a JAX node:
    the dummy client's submissions are committed, and the dummy's
    messages.txt holds the fleet's order."""

    async def go():
        app_proxy = SocketAppProxy("127.0.0.1:1", "127.0.0.1:0",
                                   timeout=1.0)
        await app_proxy.start()
        log = tmp_path / "messages.txt"
        dummy = DummySocketClient(app_proxy.bind_addr, "127.0.0.1:0",
                                  log_path=str(log))
        await dummy.start()
        app_proxy.client.target = dummy.proxy.bind_addr
        proxies = [app_proxy, JProxy()]
        nodes, proxies, failures, _ = await _fleet(["torch", "jax"], seed=33,
                                                   proxies=proxies)
        n_txs = 12
        try:
            for nd in nodes:
                nd.init()
                nd.run_task()
            for i in range(n_txs):
                if i % 2:
                    await proxies[1].submit_tx(b"jax-%02d" % i)
                else:
                    await dummy.submit_tx(b"app-%02d" % i)
            await _until(lambda: (len(dummy.state.get_messages()) >= n_txs
                                  and len(proxies[1].committed) >= n_txs),
                         120)
        finally:
            await _shutdown(nodes, failures)
            await dummy.close()
            await app_proxy.close()
        order = [tx.decode() for tx in proxies[1].committed[:n_txs]]
        assert sorted(order) == sorted(
            ("jax-%02d" if i % 2 else "app-%02d") % i for i in range(n_txs))
        assert dummy.state.get_messages()[:n_txs] == order
        assert log.read_text().splitlines()[:n_txs] == order
        assert failures.records == []

    asyncio.run(asyncio.wait_for(go(), 180))
