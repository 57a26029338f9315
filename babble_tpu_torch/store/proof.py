"""Signed state proofs for fast-forward bootstrap (the port's copy of
the JAX package's ``store/proof.py``).

- every engine keeps a rolling commit digest over the committed order,
  identical across honest nodes at every position
  (``consensus/digest.py``);
- a fast-forward responder signs ``(snapshot_hash, lcr, position,
  digest, epoch)`` with its participant key (``sign_snapshot_proof``);
- any peer attests ``(position, digest, epoch)`` from its own chain
  (``sign_attestation``), and a joiner requires ``n//3 + 1`` matching
  attestations before it adopts a snapshot;
- the joiner re-folds the snapshot's consensus window over its digest
  anchor (``verify_snapshot_digest``) before any network round-trip.
"""

from __future__ import annotations

import struct
from typing import Optional

from ..consensus.digest import fold
from ..crypto import keys as crypto_keys
from ..crypto.keys import KeyPair, sha256

#: v2 (membership plane): the consensus epoch is bound into both proof
#: messages — a snapshot claiming one epoch's peer set under another
#: epoch's digest, or an attestation replayed across an epoch
#: boundary, fails signature verification outright
_SNAPSHOT_TAG = b"babble-ff-snapshot:v2"
_ATTEST_TAG = b"babble-ff-attest:v2"


def snapshot_hash(snapshot: bytes) -> bytes:
    return sha256(snapshot)


def _snapshot_msg(snap_hash: bytes, lcr: int, position: int,
                  digest: str, epoch: int) -> bytes:
    return sha256(
        _SNAPSHOT_TAG + snap_hash
        + struct.pack(">qQQ", lcr, position, epoch)
        + digest.encode("ascii")
    )


def _attest_msg(position: int, digest: str, epoch: int) -> bytes:
    return sha256(
        _ATTEST_TAG + struct.pack(">QQ", position, epoch)
        + digest.encode("ascii")
    )


def sign_snapshot_proof(key: KeyPair, snap_hash: bytes, lcr: int,
                        position: int, digest: str, epoch: int = 0):
    """Responder side: sign the (snapshot, frontier, epoch) binding."""
    return key.sign_digest(
        _snapshot_msg(snap_hash, lcr, position, digest, epoch)
    )


def verify_snapshot_proof(pub_hex: str, snap_hash: bytes, lcr: int,
                          position: int, digest: str,
                          r: int, s: int, epoch: int = 0) -> bool:
    try:
        pub = crypto_keys.from_pub_bytes(
            crypto_keys.pub_hex_to_bytes(pub_hex)
        )
        return crypto_keys.verify(
            pub, _snapshot_msg(snap_hash, lcr, position, digest, epoch),
            r, s
        )
    except Exception:
        return False


def sign_attestation(key: KeyPair, position: int, digest: str,
                     epoch: int = 0):
    """Attester side: co-sign a committed frontier you hold yourself."""
    return key.sign_digest(_attest_msg(position, digest, epoch))


def verify_attestation(pub_hex: str, position: int, digest: str,
                       r: int, s: int, epoch: int = 0) -> bool:
    try:
        pub = crypto_keys.from_pub_bytes(
            crypto_keys.pub_hex_to_bytes(pub_hex)
        )
        return crypto_keys.verify(
            pub, _attest_msg(position, digest, epoch), r, s
        )
    except Exception:
        return False


def verify_snapshot_digest(engine, digest: str,
                           position: int) -> Optional[str]:
    """Local half of snapshot verification: the restored engine's
    commit-digest state must be internally consistent AND match the
    signed proof.  Returns an error string (reject the snapshot) or
    None.  Runs before any attestation round-trip — a forgery that is
    cheap to detect must be cheap to reject."""
    dg = getattr(engine, "_digest", None)
    if dg is None:
        return "snapshot engine carries no commit digest"
    if dg.length != position or dg.head != digest:
        return (
            f"snapshot digest frontier ({dg.length}, {dg.head[:12]}…) "
            f"does not match the signed proof ({position}, {digest[:12]}…)"
        )
    window = list(engine.consensus)
    start = getattr(engine.consensus, "start", 0)
    if start + len(window) != dg.length:
        return (
            f"snapshot consensus window ({start}+{len(window)} entries) "
            f"inconsistent with digest length {dg.length}"
        )
    if dg.anchor is None or dg.anchor_pos != start:
        # An un-anchorable window would skip the re-fold — which is
        # exactly the dodge a forger wants (keep the honest head, set
        # anchor=None, permute the window; the quorum then co-signs a
        # head that no longer covers what the joiner adopts).  Honest
        # responders essentially never land here: evict_to only loses
        # its anchor when the trimmed window outruns RECENT_POSITIONS
        # (consensus_window > 8192).  Reject; the joiner retries
        # another peer.
        return (
            "snapshot digest does not anchor its consensus window "
            f"(anchor_pos {dg.anchor_pos} vs window start {start}) — "
            "the committed window cannot be verified against the "
            "signed digest"
        )
    if fold(dg.anchor, window) != dg.head:
        return (
            "snapshot consensus window does not re-fold to the signed "
            "digest — committed history was rewritten"
        )
    return None
