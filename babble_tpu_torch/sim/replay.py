"""A deterministic Core replay: seeded identities, a seeded sync schedule
and one logical clock, so that Cores of either package, driven through
the same schedule, mint byte-identical events and commit the same order.

- ``replay_scalars(n, seed)``: the private scalars of ``n`` identities,
  ordered by public key (list index == canonical participant id), for
  ``crypto.keys.key_from_scalar`` of either package;
- ``sync_schedule(n, syncs, seed)``: ``(frm, to, payload)`` triples, each
  one pull of ``to`` from ``frm`` carrying 1–16 fresh 64-byte
  transactions;
- ``LogicalClock``: the ``Core.now_ns`` replay hook, a counter.
"""

from __future__ import annotations

import hashlib
import random
from typing import List, Tuple

from ..crypto.keys import P256_ORDER, key_from_scalar

#: first timestamp of a replay (2023-11-14, ns), then one tick per mint
REPLAY_BASE_TS = 1_700_000_000_000_000_000
REPLAY_TICK_NS = 1_000_000


def replay_scalars(n: int, seed: int) -> List[int]:
    """Private scalars of ``n`` seeded identities, ordered by pub hex."""
    ds = []
    for i in range(n):
        digest = hashlib.sha256(b"babble-replay-key:%d:%d" % (seed, i))
        ds.append(int.from_bytes(digest.digest(), "big")
                  % (P256_ORDER - 1) + 1)
    return sorted(ds, key=lambda d: key_from_scalar(d).pub_hex)


def sync_schedule(n: int, syncs: int, seed: int, tx_bytes: int = 64,
                  max_txs: int = 16) -> List[Tuple[int, int, List[bytes]]]:
    """``syncs`` pulls between distinct Cores, each carrying 1 to
    ``max_txs`` transactions of ``tx_bytes`` bytes, unique over the
    schedule."""
    rng = random.Random(f"babble-replay:{n}:{syncs}:{seed}")
    out = []
    for i in range(syncs):
        frm = rng.randrange(n)
        to = (frm + 1 + rng.randrange(n - 1)) % n
        txs = []
        for j in range(rng.randint(1, max_txs)):
            seed_b = hashlib.sha256(b"tx:%d:%d:%d" % (seed, i, j)).digest()
            txs.append((seed_b * (tx_bytes // 32 + 1))[:tx_bytes])
        out.append((frm, to, txs))
    return out


class LogicalClock:
    """``Core.now_ns`` for a replay: every call is one tick later."""

    def __init__(self, start: int = REPLAY_BASE_TS,
                 tick: int = REPLAY_TICK_NS):
        self.t = start
        self.tick = tick

    def __call__(self) -> int:
        self.t += self.tick
        return self.t
