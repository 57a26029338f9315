"""Random gossip DAGs of ``Event`` objects.

``random_gossip_dag`` is the port's copy of the JAX package's
``sim/generator.py random_gossip_dag``: babble's anti-entropy gossip
shape (reference node/node.go:193-222), each step one node syncs from a
random peer and creates an event whose parents are (own head, peer
head), from a seed.  Events carry deterministic pseudo-signatures (r, s)
instead of ECDSA; engines accept them with ``verify_signatures=False``.
Timestamps tick a configurable granularity so coarse grains give
median-timestamp ties.  ``random_byzantine_dag`` is the copy of its
byzantine twin: the same shape with equivocating creators.

``random_churn_dag`` (no JAX twin; a harness like ``sim/live.py``) is the
same shape over a validator set that changes: real P-256 identities,
scheduled events that carry signed join/leave transactions (and hostile
ones), joiners whose chains start at a scheduled slot and leavers that
stop minting at one.  ``feed_churn`` inserts its events into an engine
and refuses to insert a joiner's first event before the engine has
reached the epoch that admits it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.event import Event, new_event
from ..crypto.keys import P256_ORDER, KeyPair, key_from_scalar, sha256
from ..membership.transition import (
    MEMBERSHIP_MAGIC, MembershipTx, build_membership_tx,
)
from ..membership.quorum import supermajority


@dataclass
class GeneratedDag:
    participants: Dict[str, int]      # fake pub hex -> id
    events: List[Event]               # topological (generation) order
    n: int
    seed: int


def _fake_pub(i: int) -> bytes:
    # 65-byte SEC1-shaped identifier, an identity string only
    return b"\x04" + i.to_bytes(32, "big") + bytes(32)


def random_gossip_dag(
    n: int,
    n_events: int,
    seed: int = 0,
    ts_granularity_ns: int = 1_000,
    tx_bytes: int = 0,
    base_ts: int = 1_700_000_000_000_000_000,
) -> GeneratedDag:
    """Generate `n_events` events over `n` participants (including the n
    root events)."""
    rng = np.random.default_rng(seed)
    participants = {("0x" + _fake_pub(i).hex().upper()): i for i in range(n)}
    pubs = [_fake_pub(i) for i in range(n)]

    events: List[Event] = []
    heads: List[Optional[str]] = [None] * n
    seqs = [0] * n

    def sign_fake(ev: Event) -> None:
        ev.r = int(rng.integers(1, 1 << 62)) << 64 | int(rng.integers(0, 1 << 62))
        ev.s = int(rng.integers(1, 1 << 62)) << 64 | int(rng.integers(0, 1 << 62))

    t = 0
    for i in range(n):
        ev = new_event([], ("", ""), pubs[i], 0, timestamp=base_ts)
        sign_fake(ev)
        events.append(ev)
        heads[i] = ev.hex()
        seqs[i] = 1
        if len(events) >= n_events:
            return GeneratedDag(participants, events, n, seed)

    while len(events) < n_events:
        t += 1
        receiver = int(rng.integers(0, n))
        sender = int(rng.integers(0, n - 1))
        if sender >= receiver:
            sender += 1
        txs = [rng.bytes(tx_bytes)] if tx_bytes else []
        # ~2ms raw tick, quantized to the requested granularity
        raw = t * 1_987_963
        ts = base_ts + (raw // ts_granularity_ns) * ts_granularity_ns
        ev = new_event(
            txs, (heads[receiver], heads[sender]), pubs[receiver],
            seqs[receiver], timestamp=ts,
        )
        sign_fake(ev)
        events.append(ev)
        heads[receiver] = ev.hex()
        seqs[receiver] += 1

    return GeneratedDag(participants, events, n, seed)


# ----------------------------------------------------------------------
# churn: a gossip DAG over a changing validator set

#: schedule actions (``(slot, action, member, epoch)``):
#: - "join" / "leave": the event at ``slot`` carries ``member``'s signed
#:   transition stamped ``epoch``;
#: - "garbage": the event carries ``MEMBERSHIP_MAGIC`` and a body that
#:   does not parse;
#: - "forged": the event carries a join for ``member`` signed by
#:   founder 0's key (the subject's signature does not verify);
#: - "start": ``member`` (a joiner) mints its root at ``slot`` and gossips
#:   from then on; the engine must be at ``epoch`` or later by then;
#: - "stop": ``member`` mints nothing from ``slot`` on.
def random_byzantine_dag(
    n: int,
    n_events: int,
    byz_frac: float = 1 / 3,
    fork_rate: float = 0.05,
    forks_per_node: int = 1,
    seed: int = 0,
    ts_granularity_ns: int = 1_000,
    base_ts: int = 1_700_000_000_000_000_000,
) -> GeneratedDag:
    """Gossip DAG with equivocating creators (the BASELINE byzantine
    config): the first ``floor(byz_frac * n)`` participants fork with
    probability ``fork_rate`` per event they create — instead of
    extending their latest head they extend a random *earlier* own event,
    producing two events at the same index.  Each forker equivocates at
    most ``forks_per_node`` times (the engine's per-creator branch budget
    K-1).  Consumers must run fork-aware see/strongly-see
    (consensus/byzantine.py, ops/forks.py)."""
    rng = np.random.default_rng(seed)
    participants = {("0x" + _fake_pub(i).hex().upper()): i for i in range(n)}
    pubs = [_fake_pub(i) for i in range(n)]
    # BFT bound: once a creator's fork is visible, nobody can see its
    # events, so rounds only advance while the honest creators alone
    # reach a supermajority — cap forkers at n - (2n/3+1)
    n_byz = min(int(byz_frac * n), n - supermajority(n))

    events: List[Event] = []
    # per creator: (hex, index) of every own event (fork targets)
    own: List[List[tuple]] = [[] for _ in range(n)]
    forks_left = [forks_per_node if i < n_byz else 0 for i in range(n)]
    heads: List[Optional[str]] = [None] * n

    def sign_fake(ev: Event) -> None:
        ev.r = int(rng.integers(1, 1 << 62)) << 64 | int(rng.integers(0, 1 << 62))
        ev.s = int(rng.integers(1, 1 << 62)) << 64 | int(rng.integers(0, 1 << 62))

    t = 0
    for i in range(n):
        ev = new_event([], ("", ""), pubs[i], 0, timestamp=base_ts)
        sign_fake(ev)
        events.append(ev)
        own[i].append((ev.hex(), 0))
        heads[i] = ev.hex()
        if len(events) >= n_events:
            return GeneratedDag(participants, events, n, seed)

    while len(events) < n_events:
        t += 1
        receiver = int(rng.integers(0, n))
        sender = int(rng.integers(0, n - 1))
        if sender >= receiver:
            sender += 1
        raw = t * 1_987_963
        ts = base_ts + (raw // ts_granularity_ns) * ts_granularity_ns

        sp_hex, sp_idx = own[receiver][-1][0], own[receiver][-1][1]
        if (forks_left[receiver] > 0 and len(own[receiver]) > 1
                and rng.random() < fork_rate):
            # equivocate: extend a random earlier own event
            j = int(rng.integers(0, len(own[receiver]) - 1))
            sp_hex, sp_idx = own[receiver][j]
            forks_left[receiver] -= 1
        ev = new_event(
            [], (sp_hex, heads[sender]), pubs[receiver], sp_idx + 1,
            timestamp=ts,
        )
        sign_fake(ev)
        events.append(ev)
        own[receiver].append((ev.hex(), sp_idx + 1))
        heads[receiver] = ev.hex()

    return GeneratedDag(participants, events, n, seed)


CHURN_ACTIONS = ("join", "leave", "garbage", "forged", "start", "stop")

#: a membership body that is valid msgpack but no transition
GARBAGE_TX = MEMBERSHIP_MAGIC + b"\x93\xa4join\x01\xc0"


class ChurnScheduleError(RuntimeError):
    """A joiner's first event reached an engine whose epoch does not yet
    admit it: its "start" slot must move later."""


@dataclass
class ChurnDag:
    participants: Dict[str, int]      # founders: pub hex -> id
    events: List[Event]               # topological (generation) order
    keys: List[KeyPair]               # founders, then every joiner
    n: int
    seed: int
    #: slot -> (member, epoch the engine must have reached)
    starts: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    #: slot -> (action, member) of every transaction the DAG carries
    txs: Dict[int, Tuple[str, int]] = field(default_factory=dict)


def churn_key(seed: int, member: int) -> KeyPair:
    """Seeded P-256 identity of member ``member`` (founders first)."""
    d = int.from_bytes(
        sha256(b"babble-churn:%d:%d" % (seed, member)), "big")
    return key_from_scalar(d % (P256_ORDER - 1) + 1)


def member_addr(member: int) -> str:
    return f"inmem://m{member}"


def _churn_tx(action: str, member: int, epoch: int,
              keys: List[KeyPair]) -> bytes:
    if action in ("join", "leave"):
        return build_membership_tx(action, keys[member],
                                   member_addr(member), epoch)
    if action == "garbage":
        return GARBAGE_TX
    # "forged": the subject's join, signed by founder 0
    spec = MembershipTx(kind="join", pub_hex=keys[member].pub_hex,
                        net_addr=member_addr(member), epoch=epoch)
    r, s = keys[0].sign_digest(spec.signing_digest())
    return MembershipTx(spec.kind, spec.pub_hex, spec.net_addr, spec.epoch,
                        r, s).pack()


def random_churn_dag(
    n: int,
    n_events: int,
    seed: int,
    schedule: Sequence[Tuple[int, str, int, int]],
    base_ts: int = 1_700_000_000_000_000_000,
) -> ChurnDag:
    """``random_gossip_dag``'s shape over ``n`` founders and the joiners
    the schedule names (module docstring; ``CHURN_ACTIONS``).  Event
    signatures are pseudo-signatures; the transactions are really
    signed."""
    rng = np.random.default_rng(seed)
    members = max([n - 1] + [m for _, _, m, _ in schedule]) + 1
    keys = [churn_key(seed, m) for m in range(members)]
    participants = {keys[i].pub_hex: i for i in range(n)}
    by_slot: Dict[int, Tuple[str, int, int]] = {}
    for slot, action, member, epoch in schedule:
        if action not in CHURN_ACTIONS:
            raise ValueError(f"unknown churn action {action!r}")
        if slot < n or slot >= n_events or slot in by_slot:
            raise ValueError(f"churn slot {slot} is taken or out of range")
        by_slot[slot] = (action, member, epoch)
    out = ChurnDag(participants, [], keys, n, seed)

    heads: List[Optional[str]] = [None] * members
    seqs = [0] * members
    minting = list(range(n))

    def sign_fake(ev: Event) -> None:
        ev.r = int(rng.integers(1, 1 << 62)) << 64 | int(rng.integers(0, 1 << 62))
        ev.s = int(rng.integers(1, 1 << 62)) << 64 | int(rng.integers(0, 1 << 62))

    def root(m: int, ts: int) -> None:
        ev = new_event([], ("", ""), keys[m].pub_bytes, 0, timestamp=ts)
        sign_fake(ev)
        out.events.append(ev)
        heads[m] = ev.hex()
        seqs[m] = 1

    for i in range(n):
        root(i, base_ts)
    t = 0
    while len(out.events) < n_events:
        t += 1
        slot = len(out.events)
        ts = base_ts + (t * 1_987_963 // 1_000) * 1_000
        action, member, epoch = by_slot.get(slot, (None, 0, 0))
        if action == "start":
            root(member, ts)
            minting.append(member)
            out.starts[slot] = (member, epoch)
            continue
        if action == "stop":
            minting.remove(member)
        txs = []
        if action in ("join", "leave", "garbage", "forged"):
            txs = [_churn_tx(action, member, epoch, keys)]
            out.txs[slot] = (action, member)
        receiver = minting[int(rng.integers(0, len(minting)))]
        sender = minting[int(rng.integers(0, len(minting) - 1))]
        if sender == receiver:
            sender = minting[-1]
        ev = new_event(
            txs, (heads[receiver], heads[sender]), keys[receiver].pub_bytes,
            seqs[receiver], timestamp=ts,
        )
        sign_fake(ev)
        out.events.append(ev)
        heads[receiver] = ev.hex()
        seqs[receiver] += 1
    return out


def feed_churn(engine, dag: ChurnDag, lo: int, hi: int,
               convert=None) -> None:
    """Insert ``dag.events[lo:hi]`` into ``engine`` (each through
    ``convert``, a clone by default), refusing a joiner's first event
    while the engine's epoch is below the scheduled one or the engine
    has not admitted the joiner yet (transitions apply in commit order,
    which need not be the schedule's)."""
    convert = convert or Event.clone
    for slot in range(lo, hi):
        start = dag.starts.get(slot)
        if start is not None and (
                engine.epoch < start[1]
                or dag.keys[start[0]].pub_hex not in engine.participants):
            raise ChurnScheduleError(
                f"joiner {start[0]} starts minting at slot {slot}, but the "
                f"engine (epoch {engine.epoch}, want {start[1]}) has not "
                f"admitted it: move slot {slot} later"
            )
        engine.insert_event(convert(dag.events[slot]))
