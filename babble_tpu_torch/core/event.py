"""Hashgraph events: the DAG's vertices (the port's copy of the JAX
package's ``core/event.py`` identity half).

- ``EventBody`` (reference event.go:29-42) with int64-nanosecond
  timestamps; its ``canonical_bytes`` are the msgpack encoding of
  ``[txs, self_parent, other_parent, creator, timestamp, index]`` with
  ``use_bin_type=True``, written here by hand (``_pack``) for exactly
  the types a body holds, so the port needs no msgpack package.  Event
  ids, the coin bit, the order's whitening and the commit digest all
  hash these bytes: one wrong byte changes the committed order.
- SHA-256 identity hash over body + signature scalars; hex id "0x..."
  (event.go:169-186).

Signing, ``verify`` and the wire forms need the crypto module, which is
not ported yet (ROADMAP.md Queue 1, item 5).
"""

from __future__ import annotations

import hashlib
import struct
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Signature scalars are P-256 field elements: 32 bytes each.
_SCALAR_BYTES = 32

NOT_PORTED_CRYPTO = (
    "signatures and wire forms are not ported yet (ROADMAP.md Queue 1, "
    "item 5: the node runtime's crypto and wire forms)"
)


def _int_to_b32(v: int) -> bytes:
    return v.to_bytes(_SCALAR_BYTES, "big")


def _sized(n: int, fix: Optional[Tuple[int, int]], tags) -> bytes:
    """Header of a msgpack str/bin/array of length ``n``: the fix form
    ``(base, limit)`` when it fits, else the 8/16/32-bit length form
    (``tags`` maps a length width to its type byte)."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for width, fmt in ((8, ">B"), (16, ">H"), (32, ">I")):
        if width in tags and n < (1 << width):
            return bytes([tags[width]]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(v: int) -> bytes:
    """The smallest msgpack int form of ``v``, chosen as msgpack-python
    chooses it (unsigned forms for v >= 0, signed ones below)."""
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -0x20 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, bits in ((0xD0, ">b", 8), (0xD1, ">h", 16),
                               (0xD2, ">i", 32), (0xD3, ">q", 64)):
            if v >= -(1 << (bits - 1)):
                return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack(obj) -> bytes:
    """msgpack ``packb(obj, use_bin_type=True)`` for the types of an
    event body: list, str, bytes-like and int (bool refused)."""
    if isinstance(obj, bool):
        raise TypeError("bool has no place in an event body")
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        return _sized(len(b), (0xA0, 32),
                      {8: 0xD9, 16: 0xDA, 32: 0xDB}) + b
    if isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        return _sized(len(b), None, {8: 0xC4, 16: 0xC5, 32: 0xC6}) + b
    if isinstance(obj, (list, tuple)):
        return _sized(len(obj), (0x90, 16), {16: 0xDC, 32: 0xDD}) + \
            b"".join(_pack(x) for x in obj)
    raise TypeError(f"cannot encode {type(obj).__name__} in an event body")


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


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
        return _pack([
            list(self.transactions),
            self.self_parent,
            self.other_parent,
            self.creator,
            self.timestamp,
            self.index,
        ])

    def digest(self) -> bytes:
        return sha256(self.canonical_bytes())


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
            self._hash = sha256(
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

    def verify(self) -> bool:
        raise NotImplementedError(NOT_PORTED_CRYPTO)


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
