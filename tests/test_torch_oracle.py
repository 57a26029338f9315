"""The port's straight-line oracle (``consensus/oracle.py
OracleHashgraph``) and its Store (``store/inmem.py InmemStore``), on the
CPU:

- ``tests/test_oracle.py``'s cases replayed on the port (the reference's
  fixture DAGs, built from the same plays and key scalars with the
  port's event and key classes);
- the port's oracle against the JAX package's, field by field, on the
  fixtures and on random gossip flows with consensus between chunks;
- ``TorchHashgraph(device="cpu")`` against the port's oracle on
  ``tests/test_engine.py``'s differential flows, and on the rolling-window
  flow ``chip_smoke.py`` phase 13(f) runs on the card (``oracle_flow``);
- the port's ``ForkOracle`` against the oracle on honest DAGs
  (``tests/test_forks.py:51-60``).
"""

import itertools

import numpy as np
import pytest

from babble_tpu.consensus.oracle import OracleHashgraph as JOracle
from babble_tpu.crypto.keys import key_from_scalar as jkey_from_scalar
from babble_tpu.sim import generator as jgen
from babble_tpu.store.inmem import InmemStore as JStore

import chip_smoke
from babble_tpu_torch import OracleHashgraph, TorchHashgraph
from babble_tpu_torch.consensus import ForkOracle
from babble_tpu_torch.core.event import new_event
from babble_tpu_torch.crypto.keys import key_from_scalar
from babble_tpu_torch.sim.generator import random_gossip_dag
from babble_tpu_torch.store import InmemStore, RoundEvent, RoundInfo

from . import fixtures
from .test_torch_engine import _port_event

CPU = "cpu"
_SCALARS = itertools.count(7001)


class PortFixture:
    """A ``tests/fixtures.py`` DAG with the port's classes: the same
    plays, timestamps and (seeded) key scalars, so the same event ids."""

    def __init__(self, make):
        used = []

        def key():
            used.append(next(_SCALARS))
            return jkey_from_scalar(used[-1])

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fixtures, "generate_key", key)
            self.jax = make()
        self.keys = [key_from_scalar(d) for d in used]
        self.participants = dict(self.jax.participants)
        assert self.participants == {k.pub_hex: i
                                     for i, k in enumerate(self.keys)}
        self.events = [_port_event(e) for e in self.jax.ordered_events]
        assert [e.hex() for e in self.events] == \
            [e.hex() for e in self.jax.ordered_events]
        self.index = self.jax.index
        self.name_of = self.jax.name_of

    def oracle(self, cache_size: int = 100):
        h = OracleHashgraph(participants=self.participants,
                            store=InmemStore(self.participants, cache_size))
        for ev in self.events:
            h.insert_event(ev.clone())
        return h


# ----------------------------------------------------------------------
# tests/test_oracle.py on the port


class TestAncestry:
    @pytest.fixture(scope="class")
    def setup(self):
        fx = PortFixture(fixtures.simple_fixture)
        return fx.oracle(), fx.index

    def test_ancestor(self, setup):
        h, idx = setup
        for x, y in (("e01", "e0"), ("e01", "e1"), ("e20", "e01"),
                     ("e20", "e2"), ("e12", "e20"), ("e12", "e1"),
                     ("e20", "e0"), ("e20", "e1"), ("e12", "e01"),
                     ("e12", "e2"), ("e12", "e0")):
            assert h.ancestor(idx[x], idx[y]), (x, y)
        assert not h.ancestor(idx["e01"], idx["e2"])

    def test_self_ancestor(self, setup):
        h, idx = setup
        for x, y in (("e01", "e0"), ("e20", "e2"), ("e12", "e1")):
            assert h.self_ancestor(idx[x], idx[y]), (x, y)
        for x, y in (("e01", "e1"), ("e20", "e01"), ("e12", "e20"),
                     ("e20", "e0"), ("e12", "e2")):
            assert not h.self_ancestor(idx[x], idx[y]), (x, y)

    def test_see(self, setup):
        h, idx = setup
        for x, y in (("e01", "e0"), ("e01", "e1"), ("e20", "e0"),
                     ("e20", "e01"), ("e12", "e01"), ("e12", "e0"),
                     ("e12", "e1")):
            assert h.see(idx[x], idx[y]), (x, y)


def test_fork_rejection():
    """Forks (same creator, same height) are refused at insert, and so
    are events naming the forked branch (reference TestFork)."""
    fx = PortFixture(fixtures.simple_fixture)
    h = OracleHashgraph(participants=fx.participants,
                        store=InmemStore(fx.participants, 100))
    for name in ("e0", "e1", "e2"):
        h.insert_event(fx.events[list(fx.index).index(name)].clone())
    fork = new_event([b"yo"], ("", ""), fx.keys[2].pub_bytes, 0)
    fork.sign(fx.keys[2])
    with pytest.raises(ValueError):
        h.insert_event(fork)
    e01 = new_event([], (fx.index["e0"], fork.hex()), fx.keys[0].pub_bytes, 1)
    e01.sign(fx.keys[0])
    with pytest.raises(ValueError):
        h.insert_event(e01)


def test_invalid_signature_rejected():
    fx = PortFixture(fixtures.simple_fixture)
    h = OracleHashgraph(participants=fx.participants,
                        store=InmemStore(fx.participants, 100))
    ev = new_event([], ("", ""), fx.keys[0].pub_bytes, 0)
    ev.sign(fx.keys[1])
    with pytest.raises(ValueError, match="invalid signature"):
        h.insert_event(ev)
    good = new_event([], ("", ""), fx.keys[0].pub_bytes, 0)
    good.sign(fx.keys[0])
    h.insert_event(good)
    assert h.known() == {0: 1, 1: 0, 2: 0}


class TestRounds:
    @pytest.fixture(scope="class")
    def setup(self):
        fx = PortFixture(fixtures.round_fixture)
        return fx.oracle(), fx.index

    def test_strongly_see(self, setup):
        h, idx = setup
        for x, y in (("e21", "e0"), ("e02", "e10"), ("e02", "e0"),
                     ("e02", "e1"), ("f1", "e21"), ("f1", "e10"),
                     ("f1", "e0"), ("f1", "e1"), ("f1", "e2")):
            assert h.strongly_see(idx[x], idx[y]), (x, y)
        for x, y in (("e10", "e0"), ("e21", "e1"), ("e21", "e2"),
                     ("e02", "e2"), ("f1", "e02")):
            assert not h.strongly_see(idx[x], idx[y]), (x, y)

    def test_parent_round_witness_round(self, setup):
        h, idx = setup
        info = RoundInfo()
        for name in ("e0", "e1", "e2"):
            info.events[idx[name]] = RoundEvent(witness=True)
        h.store.set_round(0, info)
        for name in ("e0", "e1", "e10", "f1"):
            assert h.parent_round(idx[name]) == 0, name
        for name in ("e0", "e1", "e2", "f1"):
            assert h.witness(idx[name]), name
        for name in ("e10", "e21", "e02"):
            assert not h.witness(idx[name]), name
        assert h.round_inc(idx["f1"])
        assert not h.round_inc(idx["e02"])
        assert h.round(idx["f1"]) == 1
        assert h.round(idx["e02"]) == 0
        assert h.round_diff(idx["f1"], idx["e02"]) == 1
        assert h.round_diff(idx["e02"], idx["f1"]) == -1
        assert h.round_diff(idx["e02"], idx["e21"]) == 0
        with pytest.raises(ValueError):
            h.round_diff("", idx["e0"])

    def test_divide_rounds(self):
        fx = PortFixture(fixtures.round_fixture)
        h = fx.oracle()
        h.divide_rounds()
        assert h.store.rounds() == 2
        assert sorted(map(fx.name_of, h.store.get_round(0).witnesses())) \
            == ["e0", "e1", "e2"]
        assert [fx.name_of(w) for w in h.store.get_round(1).witnesses()] \
            == ["f1"]

    def test_insert_event_coordinates(self):
        """Coordinate vectors after insertion (reference TestInsertEvent)."""
        fx = PortFixture(fixtures.round_fixture)
        h = fx.oracle()
        idx = fx.index
        int_max = np.iinfo(np.int64).max
        c = h._coords[idx["e0"]]
        assert list(c.fd_index[:3]) == [0, 1, 1]
        assert (c.fd_hash[1], c.fd_hash[2]) == (idx["e10"], idx["e21"])
        assert list(c.la_index[:3]) == [0, -1, -1]
        c = h._coords[idx["e21"]]
        assert list(c.fd_index[:3]) == [1, 2, 1]
        assert (c.fd_hash[0], c.fd_hash[1]) == (idx["e02"], idx["f1"])
        assert list(c.la_index[:3]) == [0, 1, 1]
        c = h._coords[idx["f1"]]
        assert list(c.fd_index[:3]) == [int_max, 2, int_max]
        assert list(c.la_index[:3]) == [1, 2, 1]
        assert c.la_hash[0] == idx["e02"]
        assert h.wire_info(idx["e0"]) == (-1, -1, -1, 0)
        assert h.wire_info(idx["e21"]) == (0, 1, 1, 2)
        assert h.wire_info(idx["f1"]) == (1, 0, 1, 1)

    def test_wire_roundtrip(self):
        """ReadWireInfo resolves ints back to hashes (reference
        TestReadWireInfo)."""
        fx = PortFixture(fixtures.round_fixture)
        h = fx.oracle()
        e02 = h.store.get_event(fx.index["e02"])
        back = h.read_wire_info(h.to_wire(e02))
        assert back.body == e02.body
        assert (back.r, back.s, back.hex()) == (e02.r, e02.s, e02.hex())


class TestConsensusPipeline:
    @pytest.fixture(scope="class")
    def setup(self):
        fx = PortFixture(fixtures.consensus_fixture)
        return fx.oracle(), fx

    def test_decide_fame(self, setup):
        h, fx = setup
        idx = fx.index
        h.divide_rounds()
        h.decide_fame()
        for name in ("g0", "g1", "g2"):
            assert h.round(idx[name]) == 2, name
        round0 = h.store.get_round(0)
        for name in ("e0", "e1", "e2"):
            re = round0.events[idx[name]]
            assert re.witness and re.famous is True, name

    def test_oldest_self_ancestor_to_see(self, setup):
        h, fx = setup
        idx = fx.index
        assert h.oldest_self_ancestor_to_see(idx["f0"], idx["e1"]) == idx["e02"]
        assert h.oldest_self_ancestor_to_see(idx["f1"], idx["e0"]) == idx["e10"]
        assert h.oldest_self_ancestor_to_see(idx["e21"], idx["e1"]) == idx["e21"]
        assert h.oldest_self_ancestor_to_see(idx["e2"], idx["e1"]) == ""

    def test_find_order(self):
        fx = PortFixture(fixtures.consensus_fixture)
        h = fx.oracle()
        committed = []
        h.commit_callback = committed.extend
        h.divide_rounds()
        h.decide_fame()
        h.find_order()
        for name, hex_id in fx.index.items():
            if name.startswith("e"):
                assert h.store.get_event(hex_id).round_received == 1, name
        consensus = [fx.name_of(x) for x in h.consensus_events()]
        assert len(consensus) == 6
        expected1 = ["e0", "e10", "e1", "e21", "e2", "e02"]
        expected2 = ["e0", "e1", "e10", "e2", "e21", "e02"]
        for i, name in enumerate(consensus):
            assert name in (expected1[i], expected2[i]), consensus
        assert [e.hex() for e in committed] == h.consensus_events()
        assert h.store.consensus_events_count() == 6

    def test_known(self, setup):
        h, fx = setup
        assert h.known() == {pid: 7 for pid in fx.participants.values()}


def test_store_seam_equals_jax():
    """Every Store lookup, its prefix eviction at cache_size, the round
    cache and the consensus log, against the JAX package's InmemStore
    over the same events (reference inmem_store.go)."""
    fx = PortFixture(fixtures.consensus_fixture)
    jo, po = _oracles(fx.participants, 8)
    for jev, pev in zip(fx.jax.ordered_events, fx.events):
        jo.insert_event(jev.clone())
        po.insert_event(pev.clone())
    jo.divide_rounds()
    po.divide_rounds()

    def view(store):
        out = []
        calls = [("cache_size",), ("known",), ("rounds",),
                 ("consensus_events",), ("consensus_events_count",),
                 ("last_from", "0xnobody"), ("participant_events",
                                              "0xnobody", 0)]
        for pub in fx.participants:
            calls.append(("last_from", pub))
            calls += [("participant_events", pub, k) for k in range(8)]
            calls += [("participant_event", pub, k) for k in range(8)]
        calls += [("get_event", x) for x in fx.index.values()]
        calls += [("round_witnesses", r) for r in range(6)]
        calls += [("round_events", r) for r in range(6)]
        for name, *args in calls:
            try:
                got = getattr(store, name)(*args)
            except Exception as e:              # noqa: BLE001
                got = type(e).__name__
            if name == "get_event" and not isinstance(got, str):
                got = (got.hex(), got.round_received,
                       got.consensus_timestamp)
            out.append((name, tuple(args), got))
        return out

    want = view(jo.store)
    assert view(po.store) == want
    assert ("get_event", (fx.index["e0"],), "KeyNotFoundError") in want
    assert any(g == "TooLateError" for _, _, g in want)
    for store in (jo.store, po.store):
        store.add_consensus_event("0xa")
    assert view(po.store) == view(jo.store)


# ----------------------------------------------------------------------
# the port's oracle against the JAX package's, field by field


def _store_view(h):
    s = h.store
    rounds = {}
    for r in range(s.rounds()):
        info = s.get_round(r)
        rounds[r] = {x: (e.witness, e.famous) for x, e in info.events.items()}
    return dict(rounds=rounds, consensus=s.consensus_events(),
                count=s.consensus_events_count(), known=s.known(),
                slots=list(s.dag.slot_of.items()))


def _oracle_view(h, hexes):
    coords = {x: (c.la_index.tolist(), c.la_hash, c.fd_index.tolist(),
                  c.fd_hash) for x, c in h._coords.items()}
    events = {}
    for x in hexes:
        ev = h._event_or_none(x)
        if ev is not None:
            events[x] = (ev.topological_index, ev.round_received,
                         ev.consensus_timestamp)
    return dict(
        store=_store_view(h), coords=coords, events=events,
        round_memo=dict(h._round_memo), wire=dict(h._wire_info),
        eff_ts=dict(h._eff_ts), undetermined=list(h.undetermined_events),
        lcr=h.last_consensus_round,
        lcr_events=h.last_committed_round_events,
        txs=h.consensus_transactions,
        topo=h._topological_index,
    )


def _oracles(participants, cache_size):
    return (JOracle(participants=dict(participants), verify_signatures=False,
                    store=JStore(dict(participants), cache_size)),
            OracleHashgraph(participants=dict(participants),
                            verify_signatures=False,
                            store=InmemStore(dict(participants), cache_size)))


@pytest.mark.parametrize("make", [fixtures.simple_fixture,
                                  fixtures.round_fixture,
                                  fixtures.consensus_fixture])
def test_oracle_equals_jax_on_fixtures(make):
    fx = PortFixture(make)
    jo, po = _oracles(fx.participants, 100)
    for jev, pev in zip(fx.jax.ordered_events, fx.events):
        jo.insert_event(jev.clone())
        po.insert_event(pev.clone())
    hexes = list(fx.index.values())
    assert _oracle_view(po, hexes) == _oracle_view(jo, hexes)
    assert [e.hex() for e in po.run_consensus()] == \
        [e.hex() for e in jo.run_consensus()]
    assert _oracle_view(po, hexes) == _oracle_view(jo, hexes)
    for x in hexes:
        for y in hexes:
            for q in ("ancestor", "self_ancestor", "see", "strongly_see",
                      "oldest_self_ancestor_to_see"):
                assert getattr(po, q)(x, y) == getattr(jo, q)(x, y), q


@pytest.mark.parametrize("n,e,seed,chunk,cache,tx", [
    (4, 150, 1, 7, 100_000, 0),
    (5, 200, 2, 40, 100_000, 8),
    (3, 160, 5, 13, 100_000, 0),
])
def test_oracle_equals_jax_per_call(n, e, seed, chunk, cache, tx):
    gen = jgen.random_gossip_dag(n, e, seed=seed, tx_bytes=tx)
    jo, po = _oracles(gen.participants, cache)
    hexes = [ev.hex() for ev in gen.events]
    calls = 0
    for lo in range(0, e, chunk):
        for ev in gen.events[lo:lo + chunk]:
            jo.insert_event(ev.clone())
            po.insert_event(_port_event(ev))
        want = [x.hex() for x in jo.run_consensus()]
        assert [x.hex() for x in po.run_consensus()] == want, lo
        assert _oracle_view(po, hexes) == _oracle_view(jo, hexes), lo
        calls += 1
    assert po.consensus_events() and calls > 1
    if tx:
        assert po.consensus_transactions > 0


# ----------------------------------------------------------------------
# TorchHashgraph against the port's oracle (tests/test_engine.py)


def _compare_all(dag, oracle, engine):
    """tests/test_engine.py ``_compare_all`` on the port's pair."""
    for ev in dag.events:
        x = ev.hex()
        assert engine.round(x) == oracle.round(x), f"round {x[:12]}"
        assert engine.witness(x) == oracle.witness(x), f"witness {x[:12]}"
    for r in range(oracle.store.rounds()):
        info = oracle.store.get_round(r)
        for w in info.witnesses():
            assert engine.famous_of(r, w) == info.events[w].famous, \
                f"fame round {r} {w[:12]}"
    for ev in dag.events:
        o_ev = oracle.store.get_event(ev.hex())
        e_ev = engine.dag.events[engine.dag.slot_of[ev.hex()]]
        assert e_ev.round_received == o_ev.round_received, ev.hex()[:12]
        if o_ev.round_received is not None:
            assert e_ev.consensus_timestamp == o_ev.consensus_timestamp
    assert engine.consensus_events() == oracle.consensus_events()
    assert engine.consensus_transactions == oracle.consensus_transactions
    assert engine.last_consensus_round == oracle.last_consensus_round


def _pair(dag, **kw):
    oracle = OracleHashgraph(participants=dag.participants,
                             verify_signatures=False,
                             store=InmemStore(dag.participants, 100_000))
    engine = TorchHashgraph(dag.participants, verify_signatures=False,
                            device=CPU, **kw)
    return oracle, engine


@pytest.mark.parametrize("n,n_events,seed,grain", [
    (3, 60, 0, 1_000), (4, 150, 1, 1_000), (5, 200, 2, 1_000),
    (6, 200, 3, 1_000), (4, 150, 4, 1), (4, 150, 5, 10_000_000),
    (7, 250, 6, 1_000),
])
def test_engine_equals_oracle_batch(n, n_events, seed, grain):
    dag = random_gossip_dag(n, n_events, seed=seed, ts_granularity_ns=grain)
    oracle, engine = _pair(dag, e_cap=512, s_cap=128, r_cap=64)
    for ev in dag.events:
        oracle.insert_event(ev.clone())
        engine.insert_event(ev.clone())
    oracle.run_consensus()
    engine.run_consensus()
    _compare_all(dag, oracle, engine)


@pytest.mark.parametrize("n,n_events,seed,chunk,kw", [
    (4, 160, 10, 7, dict(e_cap=256, s_cap=64, r_cap=32)),
    (5, 200, 11, 13, dict(e_cap=256, s_cap=64, r_cap=32)),
    (4, 120, 20, 120, dict(e_cap=16, s_cap=4, r_cap=4)),     # growth
])
def test_engine_equals_oracle_incremental(n, n_events, seed, chunk, kw):
    dag = random_gossip_dag(n, n_events, seed=seed)
    oracle, engine = _pair(dag, **kw)
    for i, ev in enumerate(dag.events):
        oracle.insert_event(ev.clone())
        engine.insert_event(ev.clone())
        if (i + 1) % chunk == 0:
            oracle.run_consensus()
            engine.run_consensus()
    oracle.run_consensus()
    engine.run_consensus()
    _compare_all(dag, oracle, engine)
    assert engine.cfg.e_cap >= kw["e_cap"]


def test_engine_on_a_rolling_window_equals_oracle():
    """chip_smoke.py phase 13(f)'s flow and checks, on the CPU: the
    gated engine with rolling windows, one run_consensus every 64
    inserts (README.md's engine flow and the numbers it prints)."""
    f = chip_smoke.REF_ORACLE
    got = chip_smoke.oracle_flow(CPU, f["n"], f["e"], f["seed"], f["every"],
                                 f["engine"])
    assert (got["committed"], got["lcr"]) == (416, 9)
    assert got["evicted"] > 0 and got["fame_checks"] > 0
    assert got["round_checks"] > f["e"]


# ----------------------------------------------------------------------
# ForkOracle against the oracle on honest DAGs (tests/test_forks.py)


@pytest.mark.parametrize("n,e,seed", [(4, 150, 1), (5, 200, 2)])
def test_fork_oracle_degrades_to_the_oracle_on_honest_dags(n, e, seed):
    dag = random_gossip_dag(n, e, seed=seed)
    fo = ForkOracle(dag.participants)
    oh = OracleHashgraph(participants=dag.participants,
                         verify_signatures=False,
                         store=InmemStore(dag.participants, 100_000))
    for ev in dag.events:
        fo.insert_event(ev.clone())
        oh.insert_event(ev.clone())
    fo.run_consensus()
    oh.run_consensus()
    assert fo.consensus_events() == oh.consensus_events()
    assert len(oh.consensus_events()) > 0
    for ev in dag.events:
        assert fo.round(ev.hex()) == oh.round(ev.hex())
        assert fo.witness(ev.hex()) == oh.witness(ev.hex())
