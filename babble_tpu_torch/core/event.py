"""Hashgraph events: the DAG's vertices (the port's copy of the JAX
package's ``core/event.py``).

- ``EventBody`` (reference event.go:29-42) with int64-nanosecond
  timestamps; its ``canonical_bytes`` are the msgpack encoding of
  ``[txs, self_parent, other_parent, creator, timestamp, index]``,
  written by the port's own codec (``codec.packb``), so the port needs
  no msgpack package.  Event ids, the coin bit, the order's whitening
  and the commit digest all hash these bytes: one wrong byte changes
  the committed order.
- SHA-256 identity hash over body + signature scalars; hex id "0x..."
  (event.go:169-186).
- ECDSA (r, s) signature over the body digest (event.go:131-150), by
  the port's pure-Python P-256 backend (``crypto/keys.py``).
- ``WireEvent``: the compact wire form, parents as (creator id, index)
  ints (event.go:244-259); ``FullWireEvent``: parents as hashes and the
  creator as its key, the form checkpoints store.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..codec import packb
from ..crypto import keys as ck

# Signature scalars are P-256 field elements: 32 bytes each.
_SCALAR_BYTES = 32


def _int_to_b32(v: int) -> bytes:
    return v.to_bytes(_SCALAR_BYTES, "big")


def _check_wire_bytes(v) -> bytes:
    """Type gate for peer-decoded byte fields: a decoder can return an
    int where bytes were expected, and ``bytes(2**40)`` allocates that
    many zeros.  Copying a materialised bytes-like is bounded by the
    frame that carried it."""
    if not isinstance(v, (bytes, bytearray, memoryview)):
        raise TypeError(
            f"wire field must be bytes-like, got {type(v).__name__}")
    return bytes(v)


def middle_bit(hash_bytes: bytes) -> bool:
    """Coin-flip bit for fame coin rounds: middle byte of an event's
    identity hash non-zero (reference hashgraph.go:781-790 middleBit)."""
    return hash_bytes[len(hash_bytes) // 2] != 0


@dataclass
class EventBody:
    transactions: List[bytes]
    self_parent: str      # hex id of creator's previous event, "" for first
    other_parent: str     # hex id of the gossiped-from peer's head, "" for first
    creator: bytes        # uncompressed SEC1 public key
    timestamp: int        # creator's claimed creation time, int64 ns since epoch
    index: int            # sequence number within creator's own chain

    def canonical_bytes(self) -> bytes:
        return packb([
            list(self.transactions),
            self.self_parent,
            self.other_parent,
            self.creator,
            self.timestamp,
            self.index,
        ])

    def digest(self) -> bytes:
        return ck.sha256(self.canonical_bytes())


@dataclass
class Event:
    body: EventBody
    r: Optional[int] = None
    s: Optional[int] = None

    # engine-assigned (the reference's hidden consensus fields,
    # event.go:77-87)
    topological_index: int = -1
    round_received: Optional[int] = None
    consensus_timestamp: Optional[int] = None

    #: signature-elision marker: a later, verified event of the same
    #: creator names this one as its self-parent, so its own signature
    #: needs no check (honoured by ``HostDag.insert``)
    chain_verified: bool = field(default=False, repr=False)

    _hash: Optional[bytes] = field(default=None, repr=False)
    _hex: Optional[str] = field(default=None, repr=False)
    _creator_hex: Optional[str] = field(default=None, repr=False)

    # --- identity ---------------------------------------------------------

    @property
    def creator(self) -> str:
        if self._creator_hex is None:
            self._creator_hex = "0x" + self.body.creator.hex().upper()
        return self._creator_hex

    @property
    def self_parent(self) -> str:
        return self.body.self_parent

    @property
    def other_parent(self) -> str:
        return self.body.other_parent

    @property
    def index(self) -> int:
        return self.body.index

    @property
    def transactions(self) -> List[bytes]:
        return self.body.transactions

    def hash(self) -> bytes:
        """SHA-256 over body + signature (reference event.go:169-178)."""
        if self._hash is None:
            if self.r is None or self.s is None:
                raise ValueError("event is unsigned")
            self._hash = ck.sha256(
                self.body.canonical_bytes() + _int_to_b32(self.r)
                + _int_to_b32(self.s)
            )
        return self._hash

    def hex(self) -> str:
        if self._hex is None:
            self._hex = "0x" + self.hash().hex().upper()
        return self._hex

    def middle_bit(self) -> bool:
        """Coin-flip bit for coin rounds (see module-level middle_bit)."""
        return middle_bit(self.hash())

    def clone(self) -> "Event":
        """Fresh Event sharing the immutable body/signature but with its own
        engine-assigned consensus fields (round_received, timestamps)."""
        return Event(body=self.body, r=self.r, s=self.s)

    # --- crypto -----------------------------------------------------------

    def sign(self, key: ck.KeyPair) -> None:
        self.r, self.s = key.sign_digest(self.body.digest())
        self._hash = None
        self._hex = None

    def verify(self) -> bool:
        if self.r is None or self.s is None:
            return False
        try:
            pub = ck.from_pub_bytes(self.body.creator)
        except ValueError:
            return False
        return ck.verify(pub, self.body.digest(), self.r, self.s)

    # --- wire -------------------------------------------------------------

    def to_wire(
        self, self_parent_index: int, other_parent_creator_id: int,
        other_parent_index: int, creator_id: int,
    ) -> "WireEvent":
        return WireEvent(
            transactions=list(self.body.transactions),
            self_parent_index=self_parent_index,
            other_parent_creator_id=other_parent_creator_id,
            other_parent_index=other_parent_index,
            creator_id=creator_id,
            timestamp=self.body.timestamp,
            index=self.body.index,
            r=self.r,
            s=self.s,
        )


@dataclass
class WireEvent:
    """Compact wire form: parents as (creatorID, index) ints
    (event.go:244-259)."""

    transactions: List[bytes]
    self_parent_index: int
    other_parent_creator_id: int
    other_parent_index: int
    creator_id: int
    timestamp: int
    index: int
    r: int
    s: int

    def pack(self) -> list:
        return [
            list(self.transactions),
            self.self_parent_index,
            self.other_parent_creator_id,
            self.other_parent_index,
            self.creator_id,
            self.timestamp,
            self.index,
            _int_to_b32(self.r),
            _int_to_b32(self.s),
        ]

    @classmethod
    def unpack(cls, obj: list) -> "WireEvent":
        (txs, spi, opc, opi, cid, ts, idx, r, s) = obj
        return cls(
            transactions=[_check_wire_bytes(t) for t in txs],
            self_parent_index=spi,
            other_parent_creator_id=opc,
            other_parent_index=opi,
            creator_id=cid,
            timestamp=ts,
            index=idx,
            r=int.from_bytes(r, "big"),
            s=int.from_bytes(s, "big"),
        )


@dataclass
class FullWireEvent:
    """Self-contained wire form: parents as hashes, creator as its key
    (8 fields against the compact form's 9).  Checkpoints store events
    in this form: a restore must not need evicted parents."""

    transactions: List[bytes]
    self_parent: str
    other_parent: str
    creator: bytes
    timestamp: int
    index: int
    r: int
    s: int

    def pack(self) -> list:
        return [
            list(self.transactions),
            self.self_parent,
            self.other_parent,
            self.creator,
            self.timestamp,
            self.index,
            _int_to_b32(self.r),
            _int_to_b32(self.s),
        ]

    @classmethod
    def unpack(cls, obj: list) -> "FullWireEvent":
        (txs, sp, op, creator, ts, idx, r, s) = obj
        return cls(
            transactions=[_check_wire_bytes(t) for t in txs],
            self_parent=sp, other_parent=op,
            creator=_check_wire_bytes(creator),
            timestamp=ts, index=idx,
            r=int.from_bytes(r, "big"), s=int.from_bytes(s, "big"),
        )

    @classmethod
    def from_event(cls, ev: Event) -> "FullWireEvent":
        return cls(
            transactions=list(ev.body.transactions),
            self_parent=ev.body.self_parent,
            other_parent=ev.body.other_parent,
            creator=ev.body.creator,
            timestamp=ev.body.timestamp,
            index=ev.body.index,
            r=ev.r, s=ev.s,
        )

    def to_event(self) -> Event:
        return Event(
            body=EventBody(
                transactions=list(self.transactions),
                self_parent=self.self_parent,
                other_parent=self.other_parent,
                creator=self.creator,
                timestamp=self.timestamp,
                index=self.index,
            ),
            r=self.r, s=self.s,
        )


def new_event(
    transactions: List[bytes],
    parents: Tuple[str, str],
    creator_pub: bytes,
    index: int,
    timestamp: Optional[int] = None,
) -> Event:
    """Mirror of NewEvent (reference event.go:90-105); timestamp defaults to
    now in int64 nanoseconds."""
    if timestamp is None:
        timestamp = time.time_ns()
    body = EventBody(
        transactions=list(transactions),
        self_parent=parents[0],
        other_parent=parents[1],
        creator=creator_pub,
        timestamp=timestamp,
        index=index,
    )
    return Event(body=body)
