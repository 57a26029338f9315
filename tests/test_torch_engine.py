"""The port's consensus engine against the JAX package's, on the CPU.

Every case builds its inputs from a seed and runs them through the JAX
function and its counterpart in the port; outputs must be equal:

- host modules: the hand-written msgpack of ``canonical_bytes`` against
  ``msgpack.packb``, event ids and coin bits, the generators, ``HostDag``
  (slots, effective timestamps, pending arrays, insert errors),
  ``OffsetList``, the commit digest and ``consensus_sort``;
- device modules: ``grow_state``, ``compact_impl`` and the block form of
  fame (gated and ungated, on a state whose window reaches the last
  round row, and on a rolled live state);
- the engine: ``TorchHashgraph`` and JAX ``TpuHashgraph`` fed the same
  events with the same ``run_consensus`` calls, compared after every
  call (committed ids, commit digest, stats, host mirrors and the live
  rows of every state tensor); and the predicate surface on the
  reference's named fixture DAGs.

Reference helper (run on the CPU, about five minutes):

    JAX_PLATFORMS=cpu python -m tests.test_torch_engine

prints ``ENGINE_EXPECT`` for ``chip_smoke.py`` phase 6: the JAX
``TpuHashgraph`` run over ``random_gossip_arrays(64, 65536, seed=7)`` as
a catch-up (one ``run_consensus`` over every event) and as a live node
(the engine a ``Node`` builds, fed 256 events per ``run_consensus``,
then drained).
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import msgpack

from babble_tpu.common import OffsetList as JOffsetList
from babble_tpu.common import TooLateError as JTooLate
from babble_tpu.consensus import digest as jdigest
from babble_tpu.consensus.engine import TpuHashgraph
from babble_tpu.consensus.ordering import consensus_sort as jsort
from babble_tpu.core import dag as jdag
from babble_tpu.core import event as jevent
from babble_tpu.ops import fame as jfame
from babble_tpu.ops import ingest as jingest
from babble_tpu.ops import state as jstate
from babble_tpu.sim import arrays as jarrays
from babble_tpu.sim import generator as jgen

from babble_tpu_torch import TorchHashgraph, events_from_arrays
from babble_tpu_torch import codec, common, random_gossip_arrays
from babble_tpu_torch import random_gossip_dag
from babble_tpu_torch.consensus import digest, engine as pengine
from babble_tpu_torch.consensus.ordering import consensus_sort
from babble_tpu_torch.core import dag as pdag
from babble_tpu_torch.core import event as pevent
from babble_tpu_torch.ops import fame, ss, state

from .fixtures import consensus_fixture, round_fixture, simple_fixture

CPU = "cpu"

#: the engine a live ``Node`` builds through ``Core`` with the default
#: ``cache_size`` of 500 (node/node.py, node/core.py)
LIVE_NODE = pengine.node_engine_kwargs()
#: events per ``run_consensus`` on the live node (the engine's
#: ``LATENCY_K_MAX``)
LIVE_CHUNK = 256
#: most empty calls a drain makes
DRAIN_MAX = 64


def drive(engine, events, chunk, drain=True):
    """Insert ``events`` ``chunk`` at a time with one ``run_consensus``
    after each chunk; with ``drain``, then call it with nothing pending
    until a call commits nothing.  Returns each call's committed hex ids
    and kernel class."""
    calls = []
    for lo in range(0, len(events), chunk):
        for ev in events[lo:lo + chunk]:
            engine.insert_event(ev)
        out = engine.run_consensus()
        calls.append(([e.hex() for e in out], engine.last_kernel_class))
    for _ in range(DRAIN_MAX if drain else 0):
        out = engine.run_consensus()
        calls.append(([e.hex() for e in out], engine.last_kernel_class))
        if not out:
            break
    return calls


def flow_summary(engine, calls) -> dict:
    """What ``chip_smoke.py`` holds the port's engine to after a flow."""
    kinds = [k for _, k in calls]
    return dict(
        commit_length=engine.commit_length,
        commit_digest=engine.commit_digest,
        calls=len(calls),
        latency=kinds.count("latency"),
        throughput=kinds.count("throughput"),
        lcr=engine.last_consensus_round,
        evicted=engine.dag.slot_base,
        e_cap=engine.cfg.e_cap,
        r_cap=engine.cfg.r_cap,
        flush_fallbacks=engine.flush_fallbacks,
    )


def _port_event(ev):
    """A port Event with the JAX event's body, r and s."""
    b = ev.body
    return pevent.Event(
        body=pevent.EventBody(list(b.transactions), b.self_parent,
                              b.other_parent, b.creator, b.timestamp,
                              b.index),
        r=ev.r, s=ev.s,
    )


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _eq(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_states(ref, out, label="", rows=None):
    """Every field equal; per-event fields cut to the first ``rows``."""
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(out, f)
        if rows is not None and f in state.PER_EVENT_FIELDS:
            a, b = _np(a)[:rows], _np(b)[:rows]
        _eq(a, b, f"{label} {f}")


# ----------------------------------------------------------------------
# events: the hand-written msgpack, ids, coin bits


_INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**63 - 1, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
              -32769, -2**31, -2**31 - 1, -2**63]


def _random_body(rng, cls):
    n_tx = int(rng.choice([0, 1, 3, 15, 16, 40]))
    tx_len = [0, 1, 31, 32, 255, 256, 65535, 65536]
    txs = [rng.bytes(int(rng.choice(tx_len[:7] if i else tx_len)))
           for i in range(n_tx)]
    hexid = lambda: "0x" + rng.bytes(32).hex().upper()  # noqa: E731
    root = rng.random() < 0.3
    return cls(
        transactions=txs,
        self_parent="" if root else hexid(),
        other_parent="" if root else hexid(),
        creator=b"\x04" + rng.bytes(64),
        timestamp=int(rng.choice(_INT_EDGES[:11] + _INT_EDGES[12:]))
        if rng.random() < 0.5
        else int(rng.integers(-2**62, 2**62)),
        index=0 if root else int(rng.choice([1, 127, 128, 65536, 2**31 - 1])),
    )


@pytest.mark.parametrize("seed", range(4))
def test_canonical_bytes_equal_msgpack(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        body = _random_body(rng, pevent.EventBody)
        want = msgpack.packb(
            [list(body.transactions), body.self_parent, body.other_parent,
             body.creator, body.timestamp, body.index], use_bin_type=True)
        assert body.canonical_bytes() == want


def test_msgpack_encoder_edges():
    objs = _INT_EDGES + ["", "a" * 31, "a" * 32, "b" * 255, "c" * 256,
                         "d" * 65536, "é", b"", b"x" * 255, b"x" * 256,
                         bytearray(b"ab"), [], list(range(15)),
                         list(range(16)), [[1, [2, b"3"]], "4"],
                         True, False, None, {"a": [None, True]}]
    for o in objs:
        assert codec.packb(o) == msgpack.packb(o, use_bin_type=True), o
    for bad in (1.5, 2**64, -2**63 - 1, np.int64(3), {1, 2}):
        with pytest.raises((TypeError, OverflowError)):
            codec.packb(bad)


def test_event_ids_and_coin_bits_equal_jax():
    rng = np.random.default_rng(11)
    for _ in range(60):
        body = _random_body(rng, jevent.EventBody)
        r = int.from_bytes(rng.bytes(32), "big")
        s = int.from_bytes(rng.bytes(32), "big")
        jev = jevent.Event(body=body, r=r, s=s)
        pev = _port_event(jev)
        assert pev.hex() == jev.hex()
        assert pev.hash() == jev.hash()
        assert pev.middle_bit() == jev.middle_bit()
        assert pev.body.digest() == jev.body.digest()
        assert pev.creator == jev.creator
        assert pevent.middle_bit(pev.hash()) == jevent.middle_bit(jev.hash())
        c = pev.clone()
        assert c.hex() == pev.hex() and c.round_received is None
    unsigned = pevent.new_event([], ("", ""), b"\x04" + bytes(64), 0, 5)
    with pytest.raises(ValueError, match="unsigned"):
        unsigned.hex()
    assert unsigned.verify() is False


@pytest.mark.parametrize("n,e,seed,grain,tx", [
    (4, 90, 3, 1_000, 0), (5, 120, 4, 10_000_000, 3), (2, 40, 5, 1, 0),
])
def test_generators_equal_jax(n, e, seed, grain, tx):
    j = jgen.random_gossip_dag(n, e, seed=seed, ts_granularity_ns=grain,
                               tx_bytes=tx)
    p = random_gossip_dag(n, e, seed=seed, ts_granularity_ns=grain,
                          tx_bytes=tx)
    assert p.participants == j.participants
    assert [x.hex() for x in p.events] == [x.hex() for x in j.events]
    ja = jarrays.random_gossip_arrays(n, e, seed=seed)
    pa = random_gossip_arrays(n, e, seed=seed)
    assert pa.participants() == ja.participants()
    assert [x.hex() for x in events_from_arrays(pa)] == \
        [x.hex() for x in jarrays.events_from_arrays(ja)]


# ----------------------------------------------------------------------
# host containers: OffsetList, HostDag, digest, consensus_sort


def test_offset_list_equals_jax():
    rng = np.random.default_rng(2)
    j, p = JOffsetList(), common.OffsetList()
    for step in range(200):
        op = rng.integers(0, 4)
        if op < 2:
            j.append(step)
            p.append(step)
        elif op == 2 and len(j):
            cut = int(rng.integers(j.start, len(j) + 1))
            assert p.evict_to(cut) == j.evict_to(cut)
        for idx in (0, j.start, len(j) - 1, -1, len(j)):
            for lst in (j, p):
                try:
                    got = ("ok", lst[idx])
                except (KeyError, IndexError) as exc:
                    got = (type(exc).__name__, str(exc))
                if lst is j:
                    want = got
            assert got == want, (step, idx)
        lo = int(rng.integers(0, len(j) + 2))
        try:
            want = j[lo:]
        except JTooLate:
            with pytest.raises(common.TooLateError):
                p[lo:]
        else:
            assert p[lo:] == want
        assert len(p) == len(j) and list(p) == list(j)
        assert p.start == j.start and bool(p) == bool(j)


def _dags(n=3, verify=False):
    gen = jgen.random_gossip_dag(n, 40, seed=21)
    return (gen, jdag.HostDag(dict(gen.participants), verify_signatures=verify),
            pdag.HostDag(dict(gen.participants), verify_signatures=verify))


def _insert_both(jd, pd, jev):
    """Insert into both DAGs; returns the slot, or the InsertError
    message (which must be the same)."""
    try:
        want = ("ok", jd.insert(jev))
    except jdag.InsertError as exc:
        want = ("err", str(exc))
    try:
        got = ("ok", pd.insert(_port_event(jev)))
    except pdag.InsertError as exc:
        got = ("err", str(exc))
    assert got == want
    return want


def _compare_dags(jd, pd):
    assert pd.n_events == jd.n_events and pd.slot_base == jd.slot_base
    for f in ("levels", "sp_slot", "op_slot", "wire_meta", "eff_ts"):
        assert list(getattr(pd, f)) == list(getattr(jd, f)), f
    assert [list(c) for c in pd.chains] == [list(c) for c in jd.chains]
    assert [c.start for c in pd.chains] == [c.start for c in jd.chains]
    assert pd.slot_of == jd.slot_of
    assert pd.evicted_heads == jd.evicted_heads
    assert pd.pending == jd.pending
    assert pd.known() == jd.known()
    for a, b in zip(pd.peek_pending(), jd.peek_pending()):
        _eq(b, a, "pending")
    for pub in jd.participants:
        try:
            want = jd.last_from(pub)
        except JTooLate:
            # a creator whose whole window was evicted
            with pytest.raises(common.TooLateError):
                pd.last_from(pub)
        else:
            assert pd.last_from(pub) == want


def test_host_dag_equals_jax():
    gen, jd, pd = _dags()
    pubs = {i: bytes.fromhex(k[2:]) for k, i in gen.participants.items()}
    ev = gen.events
    for e in ev[:20]:
        assert _insert_both(jd, pd, e)[0] == "ok"
    _compare_dags(jd, pd)
    # refusals: unknown participant, second root (fork), unknown parents,
    # duplicate, bad index, self-parent of another creator, stale head
    head0 = jd.last_from(ev[0].creator)
    bad = [
        jevent.new_event([], ("", ""), b"\x04" + bytes(64), 0, 1),
        jevent.new_event([], ("", ""), pubs[0], 0, 2),
        jevent.new_event([], ("", ""), pubs[0], 5, 2),
        jevent.new_event([], ("0x" + "AB" * 32, ev[1].hex()), pubs[0], 9, 3),
        jevent.new_event([], (head0, "0x" + "CD" * 32), pubs[0], 9, 3),
        ev[5],
        jevent.new_event([], (head0, ev[1].hex()), pubs[0], 99, 4),
        jevent.new_event([], (ev[1].hex(), ev[2].hex()), pubs[0], 1, 4),
        jevent.new_event([], (ev[0].hex(), ev[1].hex()), pubs[0], 1, 4),
    ]
    for i, b in enumerate(bad):
        if b.r is None:
            b.r, b.s = 3 + i, 5 + i
        assert _insert_both(jd, pd, b)[0] == "err", i
    # timestamps outside the clamp window on both sides
    wide = jdag.TS_CLAMP_WINDOW_NS
    for ts in (0, 2**62):
        e = jevent.new_event([], (jd.last_from(ev[0].creator),
                                  jd.last_from(ev[1].creator)),
                             pubs[0], len(jd.chains[0]), ts)
        e.r, e.s = ts + 7, 9
        assert _insert_both(jd, pd, e)[0] == "ok"
    assert pdag.TS_CLAMP_WINDOW_NS == wide
    for c, r in ((5, None), (5, 3), (10**13, 4)):
        assert pdag.clamp_eff_ts(c, r) == jdag.clamp_eff_ts(c, r)
    _compare_dags(jd, pd)
    for a, b in zip(pd.take_pending(), jd.take_pending()):
        _eq(b, a, "take_pending")
    _compare_dags(jd, pd)


def test_host_dag_eviction_and_continuation():
    gen, jd, pd = _dags()
    for e in gen.events:
        _insert_both(jd, pd, e)
    jd.drop_pending()
    pd.drop_pending()
    # evict through creator 2's last event, keeping later events
    last = {i: max(jd.chains[i].window) for i in range(3)}
    c = min(last, key=last.get)
    cut = last[c] + 1
    jd.evict_prefix(cut)
    pd.evict_prefix(cut)
    _compare_dags(jd, pd)
    assert not jd.chains[c].window and c in jd.evicted_heads
    idx, horizon = jd.evicted_heads[c]
    pub = bytes.fromhex(gen.events[last[c]].creator[2:])
    other = jd.events[jd.n_events - 1].hex()
    # a wrong horizon hash, a wrong index, then the real continuation
    for sp, index, ok in (("0x" + "EE" * 32, idx + 1, False),
                          (horizon, idx + 2, False),
                          (horizon, idx + 1, True)):
        e = jevent.new_event([b"tx"], (sp, other), pub, index, 2**61)
        e.r, e.s = index, 77
        assert (_insert_both(jd, pd, e)[0] == "ok") == ok
    _compare_dags(jd, pd)
    with pytest.raises(common.TooLateError):
        pd.events[0]
    # wire conversion: the compact form of every live event, and its
    # reading back (parents resolved through the eviction horizon too)
    for slot in range(pd.slot_base, pd.n_events):
        pw = pd.to_wire(pd.events[slot])
        jw = jd.to_wire(jd.events[slot])
        assert pw.pack() == jw.pack()
        back = pd.read_wire_info(pw)
        assert back.hex() == jd.read_wire_info(jw).hex()
        assert back.hex() == pd.events[slot].hex()


def test_host_dag_verify_is_not_ported():
    """Signature checks on insert, now ported: the generator's
    pseudo-signatures are refused by both packages, a really signed
    event is taken by both."""
    from babble_tpu.crypto.keys import key_from_scalar as jkey
    from babble_tpu_torch.crypto.keys import key_from_scalar

    gen, jd, pd = _dags(verify=True)
    assert _insert_both(jd, pd, gen.events[0]) == ("err", "invalid signature")
    key, jk = key_from_scalar(77), jkey(77)
    ev = pevent.new_event([b"tx"], ("", ""), key.pub_bytes, 0, 5)
    ev.sign(key)
    jev = jevent.new_event([b"tx"], ("", ""), jk.pub_bytes, 0, 5)
    jev.sign(jk)
    assert ev.hex() == jev.hex()
    parts = {key.pub_hex: 0}
    jd2 = jdag.HostDag(dict(parts), verify_signatures=True)
    pd2 = pdag.HostDag(dict(parts), verify_signatures=True)
    assert _insert_both(jd2, pd2, jev) == ("ok", 0)


def test_commit_digest_equals_jax():
    rng = np.random.default_rng(5)
    hexes = ["0x" + rng.bytes(32).hex().upper() for _ in range(300)]
    assert digest.GENESIS_DIGEST == jdigest.GENESIS_DIGEST
    assert digest.RECENT_POSITIONS == jdigest.RECENT_POSITIONS
    assert digest.fold(digest.GENESIS_DIGEST, hexes) == \
        jdigest.fold(jdigest.GENESIS_DIGEST, hexes)
    j, p = jdigest.CommitDigest(), digest.CommitDigest()
    for i, h in enumerate(hexes):
        j.note(h)
        p.note(h)
        if i % 50 == 49:
            j.evict_to(i - 20)
            p.evict_to(i - 20)
        for pos in (0, i // 2, i - 20, i + 1, i + 2):
            assert p.digest_at(pos) == j.digest_at(pos), (i, pos)
    for f in ("head", "length", "anchor", "anchor_pos"):
        assert getattr(p, f) == getattr(j, f)
    assert list(p.recent.items()) == list(j.recent.items())


def test_consensus_sort_equals_jax():
    rng = np.random.default_rng(8)
    gen = jgen.random_gossip_dag(4, 80, seed=8)
    jev = [e.clone() for e in gen.events]
    for e in jev:
        e.round_received = int(rng.integers(0, 4)) if rng.random() < 0.9 \
            else None
        e.consensus_timestamp = int(rng.integers(0, 5))
    pev = [_port_event(e) for e in jev]
    for a, b in zip(pev, jev):
        a.round_received, a.consensus_timestamp = (b.round_received,
                                                   b.consensus_timestamp)
    prn = lambda r: (r * 0x9E3779B97F4A7C15) & ((1 << 128) - 1)  # noqa: E731
    assert [e.hex() for e in consensus_sort(pev, prn)] == \
        [e.hex() for e in jsort(jev, prn)]


# ----------------------------------------------------------------------
# device modules: grow_state, compact_impl, strongly-see, block fame


_jdiag = jax.jit(jfame.decide_fame_impl, static_argnums=(0, 2))


def _ingested(n, e, seed, r_cap, fd_mode="fast"):
    """A JAX state with a gossip DAG ingested (no fame yet), and the
    port's copy of it."""
    dag = jarrays.random_gossip_arrays(n, e, seed=seed)
    jcfg = jstate.DagConfig(n=n, e_cap=e, s_cap=dag.max_chain + 2,
                            r_cap=r_cap)
    js = jax.jit(functools.partial(jingest.ingest_impl, jcfg,
                                   fd_mode=fd_mode))(
        jstate.init_state(jcfg), batch=jarrays.batch_from_arrays(dag))
    cfg = state.DagConfig(**jcfg._asdict())
    return jcfg, js, cfg, state.state_from_numpy(cfg, js, device=CPU), dag


def test_grow_and_compact_equal_jax():
    jcfg, js, cfg, ps, dag = _ingested(5, 160, 4, 32)
    js = _jdiag(jcfg, js, False)
    ps = fame.decide_fame_impl(cfg, ps)
    jcompact = jax.jit(jstate.compact_impl, static_argnums=(0,))
    for step, (de, dr, grow) in enumerate(((17, 2, 0), (9, 0, 1), (30, 3, 0),
                                           (0, 1, 1), (11, 2, 0))):
        # evict the first de live slots: every creator's seq window
        # starts past its evicted events
        e_off = int(js.e_off)
        cr = np.asarray(js.creator)[:de]
        s_off = np.asarray(js.s_off).copy()
        for c in range(cfg.n):
            s_off[c] += int((cr == c).sum())
        js = jcompact(jcfg, js, np.int32(de), s_off, np.int32(dr))
        ps = state.compact(cfg, ps, de, torch.from_numpy(s_off), dr)
        _eq_states(js, ps, f"compact {step}")
        assert int(js.e_off) == e_off + de
        if grow:
            jn = jcfg._replace(e_cap=jcfg.e_cap * 2, s_cap=jcfg.s_cap + 8,
                               r_cap=jcfg.r_cap * 2)
            js, jcfg = jstate.grow_state(js, jcfg, jn), jn
            ps, cfg = state.grow_state(ps, cfg, state.DagConfig(
                **jn._asdict())), state.DagConfig(**jn._asdict())
            _eq_states(js, ps, f"grow {step}")
            assert ps.sp.device.type == CPU
    with pytest.raises(ValueError, match="coordinate dtypes"):
        state.grow_state(ps, cfg, cfg._replace(coord16=True))


@pytest.mark.parametrize("shape", [(7, 5, 9), (64, 64, 33), (130, 70, 257)])
def test_ss_count_forms_equal_jax(shape):
    from babble_tpu.ops import ss as jss

    a, b, k = shape
    s_hi = 13
    rng = np.random.default_rng(a * 1000 + k)
    la = rng.integers(-1, s_hi + 1, (a, k)).astype(np.int32)
    fd = rng.integers(0, s_hi + 2, (b, k)).astype(np.int32)
    fd = np.where(rng.random((b, k)) < 0.15, state.INT32_MAX, fd)
    off = rng.integers(0, 3, (k,)).astype(np.int32)
    want = np.asarray(jss.ss_counts_compare(la, fd, a_chunk=32))
    tl, tf = torch.from_numpy(la), torch.from_numpy(fd)
    _eq(want, ss.ss_counts_compare(tl, tf, a_chunk=32), "compare")
    _eq(want, ss.ss_counts_onehot(tl, tf, s_hi, k_chunk_elems=1 << 9),
        "onehot")
    _eq(jss.ss_counts_onehot(la, fd, s_hi + 3, off=off),
        ss.ss_counts_onehot(tl, tf, s_hi + 3, off=torch.from_numpy(off)),
        "onehot off")
    _eq(want, ss.ss_counts(tl, tf, s_hi, True), "dispatch")
    # the JAX dispatch takes the one-hot form on a TPU only; so does this
    assert ss.use_onehot(10_000, 32) is jss.use_onehot(10_000, 32) is False


_jblock = jax.jit(jfame.decide_fame_block_impl, static_argnums=(0, 2, 3))


@pytest.mark.parametrize("n,e,r_cap,seed,fd_mode", [
    (8, 200, 32, 1, "fast"), (16, 400, 32, 2, "fast"),
    # rounds up to r_cap (the level scan does not stop below the edge):
    # the undecided window reaches the last row, and round i + 1 is the
    # sentinel row r_cap
    (4, 220, 8, 3, "full"),
])
@pytest.mark.parametrize("gate", [False, True])
def test_block_fame_equals_jax_and_diag(n, e, r_cap, seed, fd_mode, gate):
    jcfg, js, cfg, ps, _ = _ingested(n, e, seed, r_cap, fd_mode)
    want = _jblock(jcfg, js, True, gate)
    got = fame.decide_fame_block_impl(cfg, ps, True, gate)
    _eq_states(want, got, f"block gate={gate}")
    _eq_states(_jdiag(jcfg, js, gate), got, "jax diag")
    _eq_states(fame.decide_fame_impl(cfg, ps, gate), got, "port diag")
    if r_cap == 8:
        assert int(js.max_round) >= r_cap, "the window missed the edge"
    assert int(got.lcr) >= 0


def test_block_fame_on_a_rolled_live_state():
    """batch_window=False on a compacted engine's state with a fresh,
    unvoted batch ingested (r_off > 0, seq windows rolled)."""
    gen = jgen.random_gossip_dag(4, 200, seed=31)
    je = TpuHashgraph(gen.participants, verify_signatures=False, e_cap=128,
                      s_cap=32, r_cap=32, auto_compact=True, seq_window=8,
                      compact_min=16, kernel_class="throughput")
    drive(je, gen.events[:160], 16, drain=False)
    for ev in gen.events[160:]:
        je.insert_event(ev)
    je.flush()
    assert je._r_off > 0 and je.dag.slot_base > 0
    cfg = state.DagConfig(**je.cfg._asdict())
    ps = state.state_from_numpy(cfg, je.state, device=CPU)
    for gate in (False, True):
        want = _jblock(je.cfg, je.state, False, gate)
        got = fame.decide_fame_block_impl(cfg, ps, False, gate)
        _eq_states(want, got, f"rolled gate={gate}")
        _eq_states(fame.decide_fame_impl(cfg, ps, gate), got, "port diag")


# ----------------------------------------------------------------------
# the engine, differentially against JAX TpuHashgraph


def _eq_engines(je, pe, label):
    assert pe.cfg._asdict() == je.cfg._asdict(), label
    assert pe.consensus_events() == je.consensus_events(), label
    assert pe.commit_digest == je.commit_digest, label
    assert pe.commit_length == je.commit_length, label
    assert pe.stats_snapshot() == je.stats_snapshot(), label
    for f in ("_frontier_cache", "_max_round_cache", "_lcr_cache", "_r_off",
              "flush_fallbacks", "last_kernel_class", "last_flush_bytes",
              "_ordered_total", "_received"):
        assert getattr(pe, f) == getattr(je, f), f"{label} {f}"
    _eq_states(je.state, pe.state, label,
               rows=je.dag.n_events - je.dag.slot_base)


def _flow(n, e, seed, chunk, **kw):
    """One flow through both engines, compared after every call, then two
    drain calls.  Returns the JAX engine and each call's kernel class."""
    gen = jgen.random_gossip_dag(n, e, seed=seed)
    je = TpuHashgraph(gen.participants, verify_signatures=False, **kw)
    pe = TorchHashgraph(gen.participants, verify_signatures=False,
                        device=CPU, **kw)
    drained, lo, kinds = 0, 0, []
    while drained < 2:
        hi = min(lo + chunk, e)
        for ev in gen.events[lo:hi]:
            je.insert_event(ev.clone())
            pe.insert_event(_port_event(ev))
        want = [x.hex() for x in je.run_consensus()]
        got = [x.hex() for x in pe.run_consensus()]
        assert got == want, f"call at slot {lo}"
        _eq_engines(je, pe, f"call at slot {lo}")
        kinds.append(je.last_kernel_class)
        drained += lo == hi
        lo = hi
    assert pe.last_consensus_round == je.last_consensus_round
    assert pe.undetermined_count == je.undetermined_count
    return je, kinds


_TINY = dict(e_cap=32, s_cap=8, r_cap=4, auto_compact=True, seq_window=6,
             compact_min=16)


@pytest.mark.parametrize("n,e,seed,chunk,kw,expect", [
    # live node shape: auto dispatch, gated, packed votes
    (4, 120, 0, 8, dict(finality_gate=True, e_cap=256, s_cap=64, r_cap=32),
     {"latency"}),
    # one event per call, pinned latency, ungated, f32 votes, full-height
    # frontier
    (5, 60, 1, 1, dict(kernel_class="latency", packed_votes=False,
                       frontier=False, e_cap=256, s_cap=64, r_cap=32),
     {"latency"}),
    # bulk catch-up from tiny capacities: e/s/r growth
    (8, 200, 2, 200, dict(e_cap=16, s_cap=4, r_cap=4),
     {"throughput", "grow"}),
    # a bulk batch with latency pinned: its 55 levels could pass the
    # round capacity, so that call takes the throughput surface
    (4, 100, 7, 100, dict(kernel_class="latency", e_cap=128, s_cap=32,
                          r_cap=16), {"latency", "throughput"}),
    # rolling windows from tiny capacities, each surface
    (5, 160, 4, 16, dict(kernel_class="throughput", **_TINY),
     {"throughput", "compact", "grow"}),
    # two validators: rounds outrun the levels/4 estimates, so the latency
    # window falls back and a bulk flush repairs clipped rounds
    (2, 300, 4, 16, dict(finality_gate=True, **_TINY),
     {"latency", "throughput", "fallback", "compact", "grow"}),
    (2, 300, 4, 30, dict(finality_gate=True, **_TINY),
     {"throughput", "repair", "compact"}),
])
def test_engine_equals_jax_per_call(n, e, seed, chunk, kw, expect,
                                    monkeypatch):
    repairs = []
    orig = pengine.TorchHashgraph._repair_rounds

    def spy(self):
        repairs.append(1)
        return orig(self)

    monkeypatch.setattr(pengine.TorchHashgraph, "_repair_rounds", spy)
    je, kinds = _flow(n, e, seed, chunk, **kw)
    assert je.commit_length > 0
    seen = set(kinds)
    if repairs:
        seen.add("repair")
    if je.flush_fallbacks:
        seen.add("fallback")
    if je.dag.slot_base > 0 and je._r_off > 0:
        seen.add("compact")
    if je.cfg.e_cap > kw["e_cap"] and je.cfg.r_cap > kw["r_cap"]:
        seen.add("grow")
    assert expect <= seen, f"missing {expect - seen}"


def test_engine_block_fame_forced(monkeypatch):
    """BLOCK_FAME_THRESHOLD forced low: the port's engine decides fame in
    the block form and still commits what the JAX engine (diagonal
    form) commits."""
    calls = []
    orig = fame.decide_fame_block_impl

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(fame, "BLOCK_FAME_THRESHOLD", 1)
    monkeypatch.setattr(fame, "decide_fame_block_impl", spy)
    _flow(5, 200, 6, 40, kernel_class="throughput", finality_gate=True,
          e_cap=256, s_cap=64, r_cap=32)
    assert calls


def test_engine_host_views_do_not_alias_state():
    gen = jgen.random_gossip_dag(4, 60, seed=9)
    pe = TorchHashgraph(gen.participants, verify_signatures=False,
                        device=CPU, e_cap=64, s_cap=32, r_cap=16)
    for ev in gen.events:
        pe.insert_event(_port_event(ev))
    taken = []
    orig = pe.dag.take_pending

    def keep():
        out = orig()
        taken.extend(out)
        return out

    pe.dag.take_pending = keep
    batch, _ = pe.build_batch()
    for t in batch:
        for a in taken:
            assert not np.shares_memory(t.numpy(), a)
    pe.run_consensus()
    for name in ("rr", "round", "la", "wslot"):
        view = pe._arr(name)
        assert not np.shares_memory(view, getattr(pe.state, name).numpy())


def test_engine_refuses_membership_and_wire():
    """A committed transaction that starts with MEMBERSHIP_MAGIC but does
    not parse is refused (counted, not applied) by both engines alike,
    and the engine's wire conversion equals the JAX engine's."""
    gen = jgen.random_gossip_dag(3, 80, seed=12)
    ev = gen.events
    magic = b"\x00babble-member:v1:"
    from babble_tpu.membership.transition import MEMBERSHIP_MAGIC
    assert pengine.MEMBERSHIP_MAGIC == MEMBERSHIP_MAGIC == magic
    # the same DAG with a membership transaction on its first event
    b = ev[0].body
    first = jevent.Event(body=jevent.EventBody(
        [magic + b"join"], "", "", b.creator, b.timestamp, 0), r=ev[0].r,
        s=ev[0].s)
    hexes = {ev[0].hex(): first.hex()}
    events = [first]
    for e in ev[1:]:
        q = e.clone()
        q.body = jevent.EventBody(
            list(e.body.transactions),
            hexes.get(e.body.self_parent, e.body.self_parent),
            hexes.get(e.body.other_parent, e.body.other_parent),
            e.body.creator, e.body.timestamp, e.body.index)
        hexes[e.hex()] = q.hex()
        events.append(q)
    je = TpuHashgraph(dict(gen.participants), verify_signatures=False,
                      e_cap=128, s_cap=64, r_cap=32)
    pe = TorchHashgraph(dict(gen.participants), verify_signatures=False,
                        device=CPU, e_cap=128, s_cap=64, r_cap=32)
    for e in events:
        je.insert_event(e)
        pe.insert_event(_port_event(e))
    assert [x.hex() for x in pe.run_consensus()] == \
        [x.hex() for x in je.run_consensus()]
    assert pe.commit_length > 0 and first.hex() in pe.consensus_events()
    assert pe.membership_rejects == je.membership_rejects == 1
    assert pe.epoch == je.epoch == 0 and pe.pending_membership is None
    pf = _port_event(first)
    assert pe.to_wire(pf).pack() == je.to_wire(first).pack()
    assert pe.read_wire_info(pe.to_wire(pf)).hex() == first.hex()
    with pytest.raises(ValueError, match="kernel_class"):
        TorchHashgraph(gen.participants, device=CPU, kernel_class="x")


# ----------------------------------------------------------------------
# the predicate surface on the reference's named fixtures


@pytest.mark.parametrize("make", [simple_fixture, round_fixture,
                                  consensus_fixture])
def test_predicates_equal_jax_on_fixtures(make):
    fx = make()
    je = TpuHashgraph(fx.participants, e_cap=64, s_cap=16, r_cap=16)
    pe = TorchHashgraph(fx.participants, verify_signatures=False,
                        device=CPU, e_cap=64, s_cap=16, r_cap=16)
    for ev in fx.ordered_events:
        p = _port_event(ev)
        assert p.hex() == ev.hex()
        je.insert_event(ev.clone())
        pe.insert_event(p)
    names = list(fx.index.items())

    def surface(h):
        out = {}
        for a, x in names:
            out[("round", a)] = h.round(x)
            out[("witness", a)] = h.witness(x)
            for b, y in names:
                for q in ("ancestor", "see", "self_ancestor",
                          "strongly_see", "oldest_self_ancestor_to_see"):
                    out[(q, a, b)] = getattr(h, q)(x, y)
        for r in range(h.rounds() + 1):
            out[("round_witnesses", r)] = h.round_witnesses(r)
            for a, x in names:
                out[("famous_of", r, a)] = h.famous_of(r, x)
        out["rounds"] = h.rounds()
        out["known"] = h.known()
        out["lcr"] = h.last_consensus_round
        out["consensus"] = h.consensus_events()
        out["count"] = h.consensus_events_count()
        return out

    assert surface(pe) == surface(je)
    assert [e.hex() for e in pe.run_consensus()] == \
        [e.hex() for e in je.run_consensus()]
    assert surface(pe) == surface(je)
    assert pe.ancestor("", names[0][1]) is False
    assert pe.strongly_see("0x00", names[0][1]) is False


def test_node_engine_kwargs_match_the_node():
    """The port's copy of the engine settings a Node builds equals what
    the JAX package's Node passes to its Core and the Core to the
    engine (read off a real Core)."""
    from babble_tpu.crypto.keys import generate_key
    from babble_tpu.node.core import Core

    key = generate_key()
    participants = {key.pub_hex: 0}
    for cache in (500, 64):
        core = Core(0, key, participants, e_cap=max(cache, 64),
                    cache_size=cache, seq_window=None)
        hg = core.hg
        want = dict(e_cap=hg.cfg.e_cap, auto_compact=hg.auto_compact,
                    seq_window=hg.seq_window,
                    consensus_window=hg.consensus_window,
                    finality_gate=hg.finality_gate,
                    kernel_class=hg.kernel_class,
                    inactive_rounds=hg.inactive_rounds,
                    packed_votes=hg.cfg.packed, frontier=hg.frontier)
        assert pengine.node_engine_kwargs(cache) == want


def test_engine_defaults_to_the_card():
    """The engine's device defaults to CUDA: on a machine without a card
    it fails unless the caller asks for the CPU."""
    gen = jgen.random_gossip_dag(3, 10, seed=1)
    if torch.cuda.is_available():
        assert TorchHashgraph(gen.participants).state.sp.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            TorchHashgraph(gen.participants)


def chip_reference(n=64, e=65536, seed=7):
    """The JAX engine's two flows over the slice DAG (``ENGINE_EXPECT``)."""
    dag = jarrays.random_gossip_arrays(n, e, seed=seed)
    out = {}
    for name, kw, chunk in (("catchup", {}, e),
                            ("live", LIVE_NODE, LIVE_CHUNK)):
        eng = TpuHashgraph(dag.participants(), verify_signatures=False, **kw)
        calls = drive(eng, jarrays.events_from_arrays(dag), chunk,
                      drain=(name == "live"))
        out[name] = flow_summary(eng, calls)
        print(name, json.dumps(out[name]), flush=True)
    print("ENGINE_EXPECT = " + json.dumps(out, indent=4))


if __name__ == "__main__":
    chip_reference()
