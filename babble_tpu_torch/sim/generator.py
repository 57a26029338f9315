"""Random gossip DAG of ``Event`` objects (the port's copy of the JAX
package's ``sim/generator.py random_gossip_dag``).

Emulates babble's anti-entropy gossip shape (reference
node/node.go:193-222): each step one node syncs from a random peer and
creates an event whose parents are (own head, peer head), from a seed.
Events carry deterministic pseudo-signatures (r, s) instead of ECDSA;
engines accept them with ``verify_signatures=False``.  Timestamps tick a
configurable granularity so coarse grains give median-timestamp ties.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..core.event import Event, new_event


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
