"""Rolling commit digest over the committed order (the port's copy of the
JAX package's ``consensus/digest.py``, without the checkpoint meta):

    d_0 = H("babble-commit-digest:v1")
    d_k = H(d_{k-1} || entry_k)

The committed order is replica-invariant, so ``d_k`` is identical on
every honest node at every position k.  The digest is O(1) state;
``recent`` keeps the last ``RECENT_POSITIONS`` per-position digests for
attestation, and ``anchor`` the digest at the consensus window's start
(advanced by ``evict_to`` with the engine's window trim).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Iterable, Optional


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


GENESIS_DIGEST = _sha256(b"babble-commit-digest:v1").hex()

#: per-position digests retained for attestation
RECENT_POSITIONS = 8192


def fold(anchor: str, entries: Iterable[str]) -> str:
    """Extend digest ``anchor`` over consensus entries (hex ids)."""
    d = bytes.fromhex(anchor)
    for e in entries:
        d = _sha256(d + e.encode("ascii"))
    return d.hex()


class CommitDigest:
    __slots__ = ("head", "length", "anchor", "anchor_pos", "recent")

    def __init__(self):
        self.head: str = GENESIS_DIGEST
        self.length: int = 0
        #: digest covering the consensus window's evicted prefix:
        #: ``fold(anchor, window)`` reproduces ``head``
        self.anchor: Optional[str] = GENESIS_DIGEST
        self.anchor_pos: int = 0
        self.recent: "OrderedDict[int, str]" = OrderedDict()

    def note(self, entry_hex: str) -> None:
        """One committed entry appended (call next to consensus.append)."""
        self.head = _sha256(
            bytes.fromhex(self.head) + entry_hex.encode("ascii")
        ).hex()
        self.length += 1
        self.recent[self.length] = self.head
        while len(self.recent) > RECENT_POSITIONS:
            self.recent.popitem(last=False)

    def digest_at(self, position: int) -> Optional[str]:
        """Digest after the first ``position`` committed entries, or
        None when the position is ahead of us or rolled off history."""
        if position == self.length:
            return self.head
        if position == self.anchor_pos:
            return self.anchor
        if position == 0:
            # positions never evict below the anchor, so a non-zero
            # anchor_pos means d_0 history is gone
            return GENESIS_DIGEST if self.anchor_pos == 0 else None
        return self.recent.get(position)

    def evict_to(self, new_start: int) -> None:
        """The engine trimmed its consensus window to ``new_start``:
        re-anchor there (None when that digest rolled off ``recent``)."""
        if new_start <= self.anchor_pos:
            return
        self.anchor = self.digest_at(new_start)
        self.anchor_pos = new_start
        for pos in [p for p in self.recent if p <= new_start]:
            del self.recent[pos]
