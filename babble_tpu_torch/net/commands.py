"""RPC verbs: sync, fast-forward, push (reference net/commands.go:20-29).

SyncRequest carries the requester's Known map (participant id -> event
count, the gossip vector clock); SyncResponse returns the responder's head
plus the wire events the requester lacks — and, since the ingress-plane
PR, the responder's OWN Known map, which seeds the requester's
speculative-push state (see PushRequest).

PushRequest is the pipelined half of gossip: instead of the lockstep
request/response exchange (ask for the peer's diff, wait a full RTT,
then mint), a node speculatively ships the events it believes the peer
lacks — keyed on the last Known map it saw from that peer — together
with its own head and Known.  The receiver inserts, mints a merge event
carrying its pooled transactions, and acks with its updated Known; the
classic Sync exchange remains the reconciliation path when the
speculation was wrong or stale.

Every command also reports ``approx_size()``: a cheap host-side size
estimate (no encoding) that the transport's off-loop codec uses to
decide whether to serialize on the event loop (small frames: the
executor hop costs more than the encode) or on the codec thread.

The port's copy of the JAX package's ``net/commands.py``: every command
packs to the JAX package's bytes through ``codec.py`` and unpacks with
msgpack's default ``strict_map_key=True``, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..codec import packb, unpackb
from ..core.event import FullWireEvent, WireEvent

RPC_SYNC = 0


def _sig_out(v: int) -> bytes:
    """ECDSA scalars are 256-bit; msgpack ints cap at 64 bits.  The
    event wire forms always shipped them as 32-byte blobs — the
    proof-bearing commands (fast-forward / attestations) packed raw
    ints, which only the serialization-free in-memory transport
    tolerated; over TCP the encode raised OverflowError and the
    catch-up silently degraded to a retry loop.  Encode as blobs,
    accept both forms on unpack."""
    return int(v).to_bytes(32, "big")


def _sig_in(v) -> int:
    if isinstance(v, (bytes, bytearray)):
        return int.from_bytes(v, "big")
    return int(v)


def _unpack_events(events) -> List[WireEvent]:
    # 9 fields = compact WireEvent; 8 = byzantine-mode FullWireEvent
    return [
        WireEvent.unpack(e) if len(e) == 9 else FullWireEvent.unpack(e)
        for e in events
    ]


def _approx_events_size(events) -> int:
    # per-event envelope (parent refs, ids, timestamp, signature ints)
    # plus transaction payload bytes; len() only — never encodes
    return sum(
        96 + sum(len(t) for t in e.transactions) for e in events
    )


@dataclass
class SyncRequest:
    from_addr: str
    known: Dict[int, int]

    def pack(self) -> bytes:
        return packb([self.from_addr, sorted(self.known.items())])

    @classmethod
    def unpack(cls, data: bytes) -> "SyncRequest":
        from_addr, known = unpackb(data)
        return cls(from_addr=from_addr, known={int(k): int(v) for k, v in known})

    def approx_size(self) -> int:
        return 64 + 16 * len(self.known)


@dataclass
class SyncResponse:
    from_addr: str
    head: str
    events: List[WireEvent] = field(default_factory=list)
    #: the responder's own vector clock at response time — the
    #: requester caches it as that peer's last-seen Known, keying the
    #: next speculative push (pipelined gossip)
    known: Dict[int, int] = field(default_factory=dict)

    def pack(self) -> bytes:
        return packb(
            [self.from_addr, self.head, [e.pack() for e in self.events],
             sorted(self.known.items())],
        )

    @classmethod
    def unpack(cls, data: bytes) -> "SyncResponse":
        from_addr, head, events, known = unpackb(data)
        return cls(
            from_addr=from_addr,
            head=head,
            events=_unpack_events(events),
            known={int(k): int(v) for k, v in known},
        )

    def approx_size(self) -> int:
        return (64 + 16 * len(self.known)
                + _approx_events_size(self.events))


RPC_FAST_FORWARD = 1


@dataclass
class FastForwardRequest:
    """Catch-up bootstrap request (no reference counterpart: the reference
    has no recovery once a peer falls behind its rolling caches).  Sent
    when a sync returns the too-late error; the responder ships a full
    state snapshot (store.checkpoint.snapshot_bytes)."""

    from_addr: str

    def pack(self) -> bytes:
        return packb([self.from_addr])

    @classmethod
    def unpack(cls, data: bytes) -> "FastForwardRequest":
        (from_addr,) = unpackb(data)
        return cls(from_addr=from_addr)

    def approx_size(self) -> int:
        return 64


@dataclass
class FastForwardResponse:
    """Snapshot plus the responder's SIGNED state proof: the
    signature covers ``(sha256(snapshot), lcr, position, digest)``
    under the responder's participant key, binding the exact bytes
    served to a committed frontier any honest peer can attest
    (store/proof.py).  A proof-less response (``digest == ""``) is what
    pre-proof peers send; joiners with verification on reject it.
    Compat is one-directional by design: upgraded joiners still parse
    the pre-proof 2-tuple and pre-epoch 7-field forms (the guarded
    tail reads below — `pack-unpack-parity` understands the length
    gates), but older joiners cannot parse the current 8-field form —
    roll out responders last (or the fleet atomically), or a
    not-yet-upgraded laggard cannot catch up.  Field ORDER is part of
    the contract (msgpack arrays are positional): appending is the
    only compatible evolution, and the `format-version-ratchet` lint
    family pins the recorded order in `.babble-format-manifest.json`."""

    from_addr: str
    snapshot: bytes
    #: responder's last consensus round at snapshot time
    lcr: int = -1
    #: committed-log length the digest covers
    position: int = 0
    #: rolling commit digest at ``position`` ("" = no proof attached)
    digest: str = ""
    #: ECDSA signature over the proof message
    sig_r: int = 0
    sig_s: int = 0
    #: responder's consensus epoch (membership plane) — bound into the
    #: signed proof, so a snapshot cannot claim one epoch's peer set
    #: under another epoch's digest
    epoch: int = 0

    def pack(self) -> bytes:
        return packb(
            [self.from_addr, self.snapshot, self.lcr, self.position,
             self.digest, _sig_out(self.sig_r), _sig_out(self.sig_s),
             self.epoch],
        )

    @classmethod
    def unpack(cls, data: bytes) -> "FastForwardResponse":
        fields = unpackb(data)
        if len(fields) == 2:   # pre-proof peers
            from_addr, snapshot = fields
            return cls(from_addr=from_addr, snapshot=snapshot)
        if len(fields) == 7:   # pre-epoch peers
            from_addr, snapshot, lcr, position, digest, r, s = fields
            epoch = 0
        else:
            (from_addr, snapshot, lcr, position, digest, r, s,
             epoch) = fields
        return cls(from_addr=from_addr, snapshot=snapshot, lcr=int(lcr),
                   position=int(position), digest=digest,
                   sig_r=_sig_in(r), sig_s=_sig_in(s), epoch=int(epoch))

    def approx_size(self) -> int:
        return 192 + len(self.snapshot)


RPC_STATE_PROOF = 3


@dataclass
class StateProofRequest:
    """Attestation request (verified fast-forward): "co-sign your
    commit digest at ``position``".  Sent by a fast-forward joiner to
    peers OTHER than the snapshot responder; ``n//3 + 1`` matching
    signed digests (responder included) gate snapshot adoption, so a
    rewritten history needs a byzantine quorum to install.

    ``anchor=1`` asks instead for the peer's newest ROLLING ATTESTATION
    CHECKPOINT at or below ``position`` — a quorum-co-signed
    ``(position, digest, epoch)`` anchor collected every
    ``Config.anchor_interval`` commits (node._collect_anchor).  A
    joiner whose snapshot extends beyond every live attester's frontier
    falls back to it: the anchor's signature set is verifiable offline,
    so the commit suffix from the anchor to the signed head re-folds
    against quorum-backed history instead of responder trust alone."""

    from_addr: str
    position: int
    #: the snapshot's claimed epoch — attesters answer with their own,
    #: and a mismatch at the same position is a reject (an attestation
    #: from the wrong epoch cannot vouch for this peer set)
    epoch: int = 0
    #: 1 = serve the newest quorum-signed anchor <= position instead of
    #: a live attestation (rolling attestation checkpoints)
    anchor: int = 0

    def pack(self) -> bytes:
        return packb([self.from_addr, self.position, self.epoch, self.anchor])

    @classmethod
    def unpack(cls, data: bytes) -> "StateProofRequest":
        fields = unpackb(data)
        epoch = fields[2] if len(fields) > 2 else 0
        anchor = fields[3] if len(fields) > 3 else 0
        return cls(from_addr=fields[0], position=int(fields[1]),
                   epoch=int(epoch), anchor=int(anchor))

    def approx_size(self) -> int:
        return 64


@dataclass
class StateProofResponse:
    """Attestation: the responder's commit digest at the requested
    position, signed with its participant key.  ``digest == ""`` means
    "unknown" — the position is ahead of this peer or rolled off its
    retained digest history — and never counts toward the quorum.

    ``anchor`` (anchor-mode requests only) carries one quorum-signed
    rolling attestation checkpoint as ``[position, digest, epoch,
    [[pub_hex, r, s], ...]]`` — every signature an independent
    ``sign_attestation`` over the same (position, digest, epoch), so
    the bundle verifies offline against the peer set."""

    from_addr: str
    position: int
    digest: str = ""
    sig_r: int = 0
    sig_s: int = 0
    #: attester's consensus epoch, bound into the signature
    epoch: int = 0
    #: quorum-signed anchor bundle (None = no anchor available)
    anchor: Optional[list] = None

    def pack(self) -> bytes:
        anchor = None
        if self.anchor is not None:
            pos, digest, epoch, sigs = self.anchor
            anchor = [pos, digest, epoch,
                      [[pub, _sig_out(r), _sig_out(s)]
                       for pub, r, s in sigs]]
        return packb(
            [self.from_addr, self.position, self.digest,
             _sig_out(self.sig_r), _sig_out(self.sig_s), self.epoch,
             anchor],
        )

    @classmethod
    def unpack(cls, data: bytes) -> "StateProofResponse":
        fields = unpackb(data)
        epoch = fields[5] if len(fields) > 5 else 0
        anchor = fields[6] if len(fields) > 6 else None
        if anchor is not None:
            pos, digest, aepoch, sigs = anchor
            anchor = [int(pos), digest, int(aepoch),
                      [[pub, _sig_in(r), _sig_in(s)]
                       for pub, r, s in sigs]]
        return cls(from_addr=fields[0], position=int(fields[1]),
                   digest=fields[2], sig_r=_sig_in(fields[3]),
                   sig_s=_sig_in(fields[4]), epoch=int(epoch),
                   anchor=anchor)

    def approx_size(self) -> int:
        return 192 + (0 if self.anchor is None
                      else 128 * len(self.anchor[3]))


RPC_PUSH = 2


@dataclass
class PushRequest:
    """Speculative event shipment (pipelined gossip): events the sender
    believes ``to``-peer lacks, keyed on the last Known map it saw from
    that peer, plus the sender's own head + Known so the receiver can
    mint a merge event and spot divergence without another RTT."""

    from_addr: str
    known: Dict[int, int]
    head: str
    events: List[WireEvent] = field(default_factory=list)

    def pack(self) -> bytes:
        return packb(
            [self.from_addr, sorted(self.known.items()), self.head,
             [e.pack() for e in self.events]],
        )

    @classmethod
    def unpack(cls, data: bytes) -> "PushRequest":
        from_addr, known, head, events = unpackb(data)
        return cls(
            from_addr=from_addr,
            known={int(k): int(v) for k, v in known},
            head=head,
            events=_unpack_events(events),
        )

    def approx_size(self) -> int:
        return (64 + 16 * len(self.known)
                + _approx_events_size(self.events))


@dataclass
class PushResponse:
    """Push ack: the receiver's post-insert Known map.  The sender
    caches it (next push is keyed on it) and compares it against its
    own clock — a creator the receiver knows MORE of triggers the
    classic pull exchange as reconciliation."""

    from_addr: str
    known: Dict[int, int]

    def pack(self) -> bytes:
        return packb([self.from_addr, sorted(self.known.items())])

    @classmethod
    def unpack(cls, data: bytes) -> "PushResponse":
        from_addr, known = unpackb(data)
        return cls(from_addr=from_addr,
                   known={int(k): int(v) for k, v in known})

    def approx_size(self) -> int:
        return 64 + 16 * len(self.known)


SyncRequest.RTYPE = RPC_SYNC
SyncRequest.RESPONSE_CLS = SyncResponse
FastForwardRequest.RTYPE = RPC_FAST_FORWARD
FastForwardRequest.RESPONSE_CLS = FastForwardResponse
PushRequest.RTYPE = RPC_PUSH
PushRequest.RESPONSE_CLS = PushResponse
StateProofRequest.RTYPE = RPC_STATE_PROOF
StateProofRequest.RESPONSE_CLS = StateProofResponse

REQUEST_TYPES = {
    RPC_SYNC: SyncRequest,
    RPC_FAST_FORWARD: FastForwardRequest,
    RPC_PUSH: PushRequest,
    RPC_STATE_PROOF: StateProofRequest,
}
