"""Signed peer-set transition transactions (the port's copy of the JAX
package's ``membership/transition.py``).

A membership transition is an ordinary transaction whose payload is a
magic prefix plus a msgpack body::

    MEMBERSHIP_MAGIC + msgpack([kind, pub_hex, net_addr, epoch, r, s])

``kind`` is ``"join"`` or ``"leave"``; ``(r, s)`` is the subject's
ECDSA signature over the canonical message (kind, pub, addr, epoch),
the scalars as 32-byte blobs.  ``epoch`` is the epoch the transition
is valid in (replay protection).

Parsing is total and silent: ``parse_membership_tx`` returns ``None``
for anything that is not a well-formed transition, so ordinary or
hostile payloads that merely start with the magic never crash the
commit path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..codec import packb, unpackb
from ..crypto import keys as crypto_keys
from ..crypto.keys import KeyPair, sha256

#: payload prefix marking a membership transition transaction
MEMBERSHIP_MAGIC = b"\x00babble-member:v1:"

KINDS = ("join", "leave")

_SIGN_TAG = b"babble-member-sign:v1"

#: bounds a hostile payload must stay inside before any crypto runs
_MAX_ADDR = 256
_MAX_EPOCH = 1 << 32


@dataclass(frozen=True)
class MembershipTx:
    """One parsed (not yet validated-against-state) transition."""

    kind: str          # "join" | "leave"
    pub_hex: str       # subject's participant key
    net_addr: str      # gossip address (joins; informational on leaves)
    epoch: int         # epoch this transition is valid in
    sig_r: int = 0
    sig_s: int = 0

    def signing_digest(self) -> bytes:
        return sha256(_SIGN_TAG + packb(
            [self.kind, self.pub_hex, self.net_addr, self.epoch]))

    def verify(self) -> bool:
        """The subject's signature over the canonical message."""
        try:
            pub = crypto_keys.from_pub_bytes(
                crypto_keys.pub_hex_to_bytes(self.pub_hex)
            )
            return crypto_keys.verify(
                pub, self.signing_digest(), self.sig_r, self.sig_s
            )
        except Exception:
            return False

    def pack(self) -> bytes:
        # 256-bit scalars ride as fixed 32-byte blobs (msgpack ints cap
        # at 64 bits)
        return MEMBERSHIP_MAGIC + packb(
            [self.kind, self.pub_hex, self.net_addr, self.epoch,
             self.sig_r.to_bytes(32, "big"),
             self.sig_s.to_bytes(32, "big")])


def build_membership_tx(kind: str, key: KeyPair, net_addr: str,
                        epoch: int) -> bytes:
    """Construct and sign a transition for ``key``'s own identity (the
    subject signs; nobody can volunteer someone else in or out)."""
    if kind not in KINDS:
        raise ValueError(f"unknown membership kind {kind!r}")
    tx = MembershipTx(kind=kind, pub_hex=key.pub_hex, net_addr=net_addr,
                      epoch=int(epoch))
    r, s = key.sign_digest(tx.signing_digest())
    return MembershipTx(
        kind=tx.kind, pub_hex=tx.pub_hex, net_addr=tx.net_addr,
        epoch=tx.epoch, sig_r=r, sig_s=s,
    ).pack()


def parse_membership_tx(tx: bytes) -> Optional[MembershipTx]:
    """Parse a transaction payload; None for anything that is not a
    structurally well-formed transition (the signature is not checked
    here)."""
    if not isinstance(tx, (bytes, bytearray)) \
            or not tx.startswith(MEMBERSHIP_MAGIC):
        return None
    try:
        body = unpackb(bytes(tx[len(MEMBERSHIP_MAGIC):]))
        kind, pub_hex, net_addr, epoch, r, s = body
    except Exception:
        return None
    if kind not in KINDS or not isinstance(pub_hex, str) \
            or not isinstance(net_addr, str):
        return None
    if not (8 <= len(pub_hex) <= 256 and len(net_addr) <= _MAX_ADDR):
        return None
    if not isinstance(epoch, int) or not (0 <= epoch < _MAX_EPOCH):
        return None
    if not isinstance(r, (bytes, bytearray)) \
            or not isinstance(s, (bytes, bytearray)) \
            or len(r) != 32 or len(s) != 32:
        return None
    return MembershipTx(kind=kind, pub_hex=pub_hex, net_addr=net_addr,
                        epoch=int(epoch),
                        sig_r=int.from_bytes(r, "big"),
                        sig_s=int.from_bytes(s, "big"))
