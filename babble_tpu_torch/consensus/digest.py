"""Rolling commit digest over the committed order (the port's copy of the
JAX package's ``consensus/digest.py``):

    d_0 = H("babble-commit-digest:v1")
    d_k = H(d_{k-1} || entry_k)

The committed order is replica-invariant, so ``d_k`` is identical on
every honest node at every position k.  The digest is O(1) state;
``recent`` keeps the last ``RECENT_POSITIONS`` per-position digests for
attestation, and ``anchor`` the digest at the consensus window's start
(advanced by ``evict_to`` with the engine's window trim).  ``to_meta``,
``from_meta`` and ``check_meta`` carry it through a checkpoint.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, List, Optional

from ..crypto.keys import sha256

GENESIS_DIGEST = sha256(b"babble-commit-digest:v1").hex()

#: per-position digests retained for attestation
RECENT_POSITIONS = 8192


def fold(anchor: str, entries: Iterable[str]) -> str:
    """Extend digest ``anchor`` over consensus entries (hex ids)."""
    d = bytes.fromhex(anchor)
    for e in entries:
        d = sha256(d + e.encode("ascii"))
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
        self.head = sha256(
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

    # ------------------------------------------------------------------
    # checkpoint round-trip

    def to_meta(self, recent_cap: int = 1024) -> dict:
        recent: List[List] = [
            [p, d] for p, d in self.recent.items()
        ][-recent_cap:]
        return {
            "head": self.head,
            "len": self.length,
            "anchor": self.anchor,
            "anchor_pos": self.anchor_pos,
            "recent": recent,
        }

    @classmethod
    def from_meta(cls, meta: Optional[dict]) -> "CommitDigest":
        dg = cls()
        if not meta:
            return dg
        dg.head = str(meta["head"])
        dg.length = int(meta["len"])
        dg.anchor = None if meta["anchor"] is None else str(meta["anchor"])
        dg.anchor_pos = int(meta["anchor_pos"])
        dg.recent = OrderedDict(
            (int(p), str(d)) for p, d in meta.get("recent", [])
        )
        return dg

    @staticmethod
    def check_meta(meta: Optional[dict]) -> None:
        """Hostile-snapshot bounds for a serialised digest: positions
        bounded and consistent, digests well-formed hex-256, the recent
        list bounded — before any CommitDigest is built from it."""
        if meta is None:
            return
        if not isinstance(meta, dict):
            raise ValueError("snapshot digest meta is not a map")
        ln = meta.get("len")
        if not isinstance(ln, int) or not (0 <= ln <= 1 << 48):
            raise ValueError(f"snapshot digest len={ln!r} out of bounds")
        ap = meta.get("anchor_pos")
        if not isinstance(ap, int) or not (0 <= ap <= ln):
            raise ValueError(
                f"snapshot digest anchor_pos={ap!r} outside [0, {ln}]"
            )
        for name in ("head", "anchor"):
            v = meta.get(name)
            if name == "anchor" and v is None:
                continue
            if not isinstance(v, str) or len(v) != 64:
                raise ValueError(f"snapshot digest {name} malformed")
            bytes.fromhex(v)
        recent = meta.get("recent", [])
        if not isinstance(recent, (list, tuple)) or len(recent) > 65536:
            raise ValueError("snapshot digest recent list out of bounds")
        for item in recent:
            p, d = item
            if not isinstance(p, int) or not (0 < p <= ln):
                raise ValueError(
                    f"snapshot digest recent position {p!r} out of bounds"
                )
            if not isinstance(d, str) or len(d) != 64:
                raise ValueError("snapshot digest recent entry malformed")
            bytes.fromhex(d)
