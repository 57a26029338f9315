"""The port's ``Node`` in one fleet with the JAX package's, on the CPU.

Nodes of both packages gossip over ``tests/torch_bridge.py``'s network,
which packs every call with the sender's ``net/commands.py`` and unpacks
it with the receiver's (and checks that the receiver packs it back to
the same bytes):

- a mixed fleet of two JAX and two port nodes (``Config.test_config``,
  10 ms heartbeat) commits every submitted transaction, each once, with
  the same committed prefix on every node;
- a port node behind the rolling window fast-forwards from JAX
  responders (signed state proof, attestation quorum, snapshot bytes
  across the packages), and a JAX node from port responders
  (``tests/test_node.py``'s fast-forward pattern);
- peer choice and heartbeat pacing are seeded by identity exactly as in
  the JAX package (``tests/test_node.py`` selector and pacing tests).

Outcomes are asserted, never schedules; every wait is bounded.
"""

import asyncio
import logging
import random

import pytest

from babble_tpu.common import TooLateError as JTooLateError
from babble_tpu.crypto import keys as jkeys
from babble_tpu.net import Peer as JPeer
from babble_tpu.net.transport import TransportError as JTransportError
from babble_tpu.node import Config as JConfig
from babble_tpu.node import Node as JNode
from babble_tpu.node.peer_selector import RandomPeerSelector as JSelector
from babble_tpu.proxy.inmem import InmemAppProxy as JProxy

from babble_tpu_torch.common import TooLateError
from babble_tpu_torch.crypto import keys as pkeys
from babble_tpu_torch.net import InmemNetwork, Peer
from babble_tpu_torch.net.transport import TransportError
from babble_tpu_torch.node import Config, Node
from babble_tpu_torch.node.peer_selector import RandomPeerSelector
from babble_tpu_torch.proxy import InmemAppProxy
from babble_tpu_torch.sim.replay import replay_scalars

from .torch_bridge import BridgeNetwork

CPU = "cpu"


class _Failures(logging.Handler):
    """Sorts what a node of either package logs and carries on from.

    A pull or push that failed is read by its exception: a timeout
    (asyncio's, with empty text), a peer that is unreachable or gone
    (the transports' ``transport closed``, ``not connected to``,
    ``unknown peer``), or a peer behind the rolling window (a
    ``too_late`` answer, or ``TooLateError`` from the pusher's own
    diff) is counted by that class in ``exchanges``; any other exception (a ``run_consensus`` or an
    insert that raised inside the pull) is a failure.  So is a
    consensus run or an RPC the node served that failed."""

    EXCHANGES = ("gossip to %s failed: %s", "push to %s failed: %s")
    BENIGN = {"transport closed": "unreachable",
              "not connected to": "unreachable",
              "unknown peer": "unreachable", "too_late": "too late"}
    MARKS = ("consensus loop failed", "post-push consensus failed",
             "sync request failed")
    TRANSPORT_ERRORS = (JTransportError, TransportError)
    TOO_LATE = (JTooLateError, TooLateError)

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []
        self.exchanges = {}

    def emit(self, record):
        if record.msg in self.EXCHANGES:
            e = record.args[-1]
            cls = None
            if isinstance(e, TimeoutError):
                cls = "timeout"
            elif isinstance(e, self.TOO_LATE):
                cls = "too late"
            elif isinstance(e, self.TRANSPORT_ERRORS):
                cls = next((v for k, v in self.BENIGN.items()
                            if str(e).startswith(k)), None)
            if cls is None:
                self.records.append(
                    f"{record.getMessage()} ({type(e).__name__})")
            else:
                kind = f"{record.msg.split()[0]} {cls}"
                self.exchanges[kind] = self.exchanges.get(kind, 0) + 1
        elif record.levelno >= logging.WARNING:
            msg = record.getMessage()
            if any(m in msg for m in self.MARKS):
                self.records.append(msg)


def _conf(kind: str, heartbeat: float = 0.01, **kw):
    if kind == "torch":
        c = Config.test_config(heartbeat=heartbeat, device=CPU)
    else:
        c = JConfig.test_config(heartbeat=heartbeat)
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def _node(kind, conf, scalar, peers, transport, proxy):
    if kind == "torch":
        return Node(conf, pkeys.key_from_scalar(scalar),
                    [Peer(p.net_addr, p.pub_key_hex) for p in peers],
                    transport, proxy)
    return JNode(conf, jkeys.key_from_scalar(scalar),
                 [JPeer(p.net_addr, p.pub_key_hex) for p in peers],
                 transport, proxy)


def _fleet(kinds, seed, **conf_kw):
    """Nodes of ``kinds`` on one bridge network; address i is node i's
    and identities are sorted by key, so node i is participant i."""
    net = BridgeNetwork()
    scalars = replay_scalars(len(kinds), seed)
    transports = [net.transport(f"inmem://{i}", kind)
                  for i, kind in enumerate(kinds)]
    peers = [Peer(t.local_addr(), pkeys.key_from_scalar(d).pub_hex)
             for t, d in zip(transports, scalars)]
    proxies = [InmemAppProxy() if k == "torch" else JProxy() for k in kinds]
    failures = _Failures()
    nodes = []
    for i, kind in enumerate(kinds):
        conf = _conf(kind, **conf_kw)
        conf.logger.addHandler(failures)
        nodes.append(_node(kind, conf, scalars[i], peers, transports[i],
                           proxies[i]))
    for nd in nodes:
        # a failed push is logged at DEBUG
        nd.conf.logger.setLevel(logging.DEBUG)
    return net, nodes, proxies, failures


async def _until(pred, timeout, every=0.05):
    async def poll():
        while not pred():
            await asyncio.sleep(every)
    await asyncio.wait_for(poll(), timeout)


async def _shutdown(nodes, failures):
    for nd in nodes:
        await nd.shutdown()
        nd.conf.logger.removeHandler(failures)
        nd.conf.logger.setLevel(logging.WARNING)


def test_mixed_fleet_commits_every_transaction_in_one_order():
    async def go():
        net, nodes, proxies, failures = _fleet(
            ["jax", "torch", "jax", "torch"], seed=21)
        n_txs = 40
        try:
            for nd in nodes:
                nd.init()
                nd.run_task()
            for i in range(n_txs):
                await proxies[i % 4].submit_tx(b"tx-%03d" % i)
            await _until(lambda: all(len(p.committed) >= n_txs
                                     for p in proxies), 120)
        finally:
            await _shutdown(nodes, failures)
        want = {b"tx-%03d" % i for i in range(n_txs)}
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
        assert net.mismatches == []
        assert net.calls.get(("jax", "torch"), 0) > 0
        assert net.calls.get(("torch", "jax"), 0) > 0

    asyncio.run(go())


@pytest.mark.parametrize("majority,straggler", [("jax", "torch"),
                                                ("torch", "jax")])
def test_fast_forward_across_packages(majority, straggler):
    """A node partitioned before it learned anything past the roots
    falls behind the majority's rolling windows; reconnected, its syncs
    get too_late and it adopts a snapshot from a node of the other
    package (proof and attestation quorum verified), then keeps
    committing with the fleet."""

    async def go():
        kinds = [majority] * 3 + [straggler]
        net, nodes, proxies, failures = _fleet(
            kinds, seed=22, cache_size=64, seq_window=8,
            consensus_interval=0.05)
        last = nodes[3]
        try:
            for nd in nodes:
                nd.init()
            net.disconnect_all("inmem://3")
            for nd in nodes[:3]:
                nd.run_task()
            await _until(lambda: all(nd.core.hg.dag.slot_base > 8
                                     for nd in nodes[:3]), 240, 0.2)
            net.connect_all("inmem://3")
            last.run_task()
            await _until(lambda: last.core.hg.dag.slot_base > 0, 240, 0.2)
            base = last.core.hg.consensus_events_count()
            await _until(lambda: last.core.hg.consensus_events_count()
                         > base + 10, 240, 0.2)
            # both committed windows (2 x cache_size entries each) at
            # one instant: the fleet keeps committing while its nodes
            # shut down one by one, so windows read afterwards can hold
            # stretches of the order too far apart to overlap
            got = last.core.hg.consensus_events()
            ref = nodes[0].core.hg.consensus_events()
        finally:
            await _shutdown(nodes, failures)
        # a first attempt may be refused while the attesters are still
        # behind the responder's frontier; one adoption must follow
        assert int(last._m_ff_total.value) > int(last._m_ff_rejects.value)
        # the adopted window agrees with the responders' committed order
        shared = set(got) & set(ref)
        assert len(shared) > 10
        assert [x for x in got if x in shared] == \
            [x for x in ref if x in shared]
        assert net.mismatches == []
        assert failures.records == []

    asyncio.run(go())


def test_peer_choice_and_pacing_are_seeded_as_in_jax():
    """Same address -> the same peer stream as the JAX selector; same
    identity -> the same heartbeat pacing as a JAX node."""
    peers = [Peer(f"a{i}", f"0x{i}") for i in range(5)]
    jpeers = [JPeer(f"a{i}", f"0x{i}") for i in range(5)]
    for local in ("a0", "a3"):
        p, j = RandomPeerSelector(peers, local), JSelector(jpeers, local)
        got, want = [], []
        for step in range(40):
            got.append(p.next().net_addr)
            want.append(j.next().net_addr)
            if step % 3 == 0:
                p.update_last(got[-1])
                j.update_last(want[-1])
        assert got == want and local not in got
    p = RandomPeerSelector(peers, "a0", rng=random.Random(7))
    j = JSelector(jpeers, "a0", rng=random.Random(7))
    assert [p.next().net_addr for _ in range(9)] == \
        [j.next().net_addr for _ in range(9)]
    p.add_peer(Peer("a9", "0x9"))
    p.remove_peer("a1")
    assert "a1" not in {x.net_addr for x in p.peers()}

    async def go():
        # node i of each fleet holds identity i: the port node's pacing
        # stream is the JAX node's of the same identity, and identities
        # differ from each other
        net, jnodes, _, jfail = _fleet(["jax"] * 3, seed=23)
        _, pnodes, _, pfail = _fleet(["torch"] * 3, seed=23)
        try:
            seqs = [[[nd._random_timeout() for _ in range(10)]
                     for nd in fleet] for fleet in (jnodes, pnodes)]
        finally:
            await _shutdown(jnodes, jfail)
            await _shutdown(pnodes, pfail)
        assert seqs[1] == seqs[0]
        assert len({tuple(x) for x in seqs[1]}) == 3
        hb = pnodes[0].conf.heartbeat
        assert all(hb <= t < 2 * hb for t in seqs[1][0])

    asyncio.run(go())


def test_port_fleet_with_wal_restart_and_unported_options(tmp_path,
                                                           monkeypatch):
    """An all-port fleet on the port's own in-memory network: a node
    shut down mid-run restarts from its WAL directory with a new proxy,
    resumes at its published head and keeps committing.  The option
    that refused here until the port had it, ``Config.aot_dir``, now
    boots a node that shows the four build and dispatch counters on
    ``/metrics``.  On the CPU it records its shapes and warms none; the
    card's boot branch, driven here by ``aot.warms_at_boot``, warms a
    fused node's default keys and pre-sizes a fork node to the caps its
    cache root's manifest recorded, and logs the prewarm."""
    from babble_tpu_torch import cuda_build
    from babble_tpu_torch.ops import aot

    async def go():
        net = InmemNetwork()
        scalars = replay_scalars(3, 24)
        keys = [pkeys.key_from_scalar(d) for d in scalars]
        ts = [net.transport(f"inmem://{i}") for i in range(3)]
        peers = [Peer(t.local_addr(), k.pub_hex) for t, k in zip(ts, keys)]

        def conf(i):
            c = Config.test_config(heartbeat=0.01, device=CPU)
            c.wal_dir = str(tmp_path / f"wal{i}")
            c.wal_fsync = "off"
            return c

        proxies = [InmemAppProxy() for _ in range(3)]
        nodes = [Node(conf(i), keys[i], peers, ts[i], proxies[i])
                 for i in range(3)]
        for nd in nodes:
            nd.init()
            nd.run_task()
        try:
            for i in range(12):
                await proxies[i % 3].submit_tx(b"a-%02d" % i)
            await _until(lambda: all(len(p.committed) >= 12
                                     for p in proxies), 60)
            old = nodes[2]
            await old.shutdown()
            head, seq = old.core.head, old.core.seq
            proxies[2] = InmemAppProxy()
            nodes[2] = Node(conf(2), keys[2], peers,
                            net.transport("inmem://2"), proxies[2])
            assert (nodes[2].core.head, nodes[2].core.seq) == (head, seq)
            nodes[2].init()
            nodes[2].run_task()
            for i in range(12):
                await proxies[i % 3].submit_tx(b"b-%02d" % i)
            await _until(lambda: all(
                sum(t.startswith(b"b-") for t in p.committed) >= 12
                for p in proxies), 60)
        finally:
            for nd in nodes:
                await nd.shutdown()
        assert nodes[2].core.seq > seq
        assert proxies[2].committed[0] == proxies[0].committed[0]
        k = min(len(p.committed) for p in proxies)
        assert all(p.committed[:k] == proxies[0].committed[:k]
                   for p in proxies)
        stats = nodes[0].get_stats()
        assert int(stats["consensus_transactions"]) >= 24
        health = nodes[0].healthz()
        assert health["commit_length"] > 0 and not health["reasons"]

        aot_dir = str(tmp_path / "aot")
        build_dir = cuda_build.BUILD_DIR
        caps = (64, 16, 8)
        aot.record_fork_caps(aot_dir, n=3, k=Config().fork_k, caps=caps,
                             sched=(2, 4))
        logged = []
        log = logging.getLogger("test_torch_node.aot")
        log.setLevel(logging.INFO)
        handler = logging.Handler()
        handler.emit = lambda r: logged.append(r.getMessage())
        log.addHandler(handler)
        try:
            for i, (byzantine, card) in enumerate(
                    ((False, False), (True, False), (False, True),
                     (True, True)), start=8):
                monkeypatch.setattr(aot, "warms_at_boot", lambda d, on=card: on)
                c = Config.test_config(device=CPU)
                c.aot_dir, c.byzantine, c.logger = aot_dir, byzantine, log
                aot_node = Node(c, keys[0], peers,
                                net.transport(f"inmem://{i}"),
                                InmemAppProxy())
                try:
                    hg = aot_node.core.hg
                    assert hg._aot_dir == aot_dir
                    if not card:
                        assert not logged
                        assert (hg._caps == (0, 0, 0) if byzantine
                                else hg._aot == set())
                    elif byzantine:
                        assert hg._caps == caps
                        assert logged[-1] == ("AOT prewarm: 1 programs "
                                              "compiled (1 from manifest)")
                    else:
                        assert sorted(k[3:] for k in hg._aot) == sorted(
                            (kpad,) + tb for kpad, tb in aot._DEFAULT_SHAPES)
                        assert logged[-1] == ("AOT prewarm: 2 programs "
                                              "compiled (0 from manifest)")
                    # the libraries stay in the package's hash-named build
                    assert cuda_build.BUILD_DIR == build_dir
                    metrics = aot_node.registry.exposition()
                    for series in ("babble_compile_cache_hits_total",
                                   "babble_compile_cache_misses_total",
                                   "babble_xla_compiles_total",
                                   "babble_jit_traces_total"):
                        assert f"\n{series} " in metrics, series
                    assert aot_node.get_stats()["consensus_events"] == "0"
                finally:
                    await aot_node.shutdown()
        finally:
            log.removeHandler(handler)

    asyncio.run(go())


def test_shutdown_lets_an_in_flight_sync_mint_its_payload_once(tmp_path):
    """A graceful shutdown while a sync's insert-and-mint runs in the
    executor: the executor thread cannot be cancelled, so the node must
    let it finish before it cancels its tasks.  The payload is then
    minted exactly once (in the WAL) and not put back in the pool.
    Cancelling first would requeue a payload the thread still mints (a
    duplicate once the pool is minted again or the WAL replays), or lose
    it when the thread reaches the closed WAL."""
    import threading
    import time

    from babble_tpu_torch.net.commands import SyncResponse
    from babble_tpu_torch.wal import WriteAheadLog

    async def go():
        net = InmemNetwork()
        keys = [pkeys.key_from_scalar(d) for d in replay_scalars(2, 25)]
        ts = [net.transport(f"inmem://{i}") for i in range(2)]
        peers = [Peer(t.local_addr(), k.pub_hex) for t, k in zip(ts, keys)]
        wal_dir = str(tmp_path / "a")
        conf = Config.test_config(device=CPU)
        conf.wal_dir, conf.wal_fsync = wal_dir, "off"
        a = Node(conf, keys[0], peers, ts[0], InmemAppProxy())
        b = Node(Config.test_config(device=CPU), keys[1], peers, ts[1],
                 InmemAppProxy())
        a.core.probe_note("inmem://1")          # a fresh WAL probes first
        a.init()
        b.init()
        a.transaction_pool[:] = [b"pay-1", b"pay-2"]
        resp = SyncResponse(
            from_addr="inmem://1", head=b.core.head,
            events=b.core.to_wire(b.core.diff(a.core.known())),
            known=b.core.known())
        real_sync, started = a.core.sync, threading.Event()

        def slow_sync(*args):
            started.set()
            time.sleep(0.3)
            return real_sync(*args)

        a.core.sync = slow_sync
        t = asyncio.create_task(a._process_sync_response(resp))
        a._gossip_tasks.add(t)
        loop = asyncio.get_running_loop()
        assert await loop.run_in_executor(None, started.wait, 10)
        await asyncio.wait_for(a.shutdown(), 30)
        await b.shutdown()
        assert a.transaction_pool == []
        minted = [tx for ev in WriteAheadLog(wal_dir, fsync="off")
                  .recovered_events for tx in ev.transactions]
        assert sorted(minted) == [b"pay-1", b"pay-2"]

    asyncio.run(go())
