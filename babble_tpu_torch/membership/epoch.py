"""The epoch ledger: verifying a membership log against a trusted base
(the port's copy of the JAX package's ``membership/epoch.py``).

A snapshot from a later epoch carries a peer set the joiner has never
seen.  Its ``membership_log`` is a chain of custody: each entry embeds
the signed transition transaction that consensus ordered, so the joiner
replays the suffix beyond its own epoch on top of the peer set it
already trusts and checks that the result is exactly the set the
snapshot claims.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .transition import parse_membership_tx

#: hard bound on how many transitions one verification will replay —
#: a hostile log must cost nothing to reject
MAX_LOG = 4096

#: pipelined membership: a transition may be stamped up to this many
#: epochs before the epoch it applies in.  Must equal
#: consensus.engine.MEMBERSHIP_QUEUE_MAX — the engine never queues
#: deeper than this, so any wider gap in a log is a forgery.
PIPELINE_WINDOW = 64


def check_log_entry(entry: dict) -> Optional[str]:
    """Structural bounds for one serialized membership-log entry
    (checkpoint/snapshot hostile-input checking).  Returns an error
    string or None."""
    if not isinstance(entry, dict):
        return "membership log entry is not a map"
    for key, typ in (("epoch", int), ("kind", str), ("pub", str),
                     ("addr", str), ("boundary", int), ("position", int)):
        if not isinstance(entry.get(key), typ):
            return f"membership log entry field {key} malformed"
    if entry["kind"] not in ("join", "leave"):
        return f"membership log kind {entry['kind']!r} unknown"
    if not (0 < entry["epoch"] <= 1 << 32):
        return "membership log epoch out of bounds"
    if not (0 <= entry["boundary"] <= 1 << 32):
        return "membership log boundary out of bounds"
    if not (0 <= entry["position"] <= 1 << 48):
        return "membership log position out of bounds"
    tx = entry.get("tx")
    if not isinstance(tx, (bytes, bytearray)) or len(tx) > 4096:
        return "membership log tx malformed"
    return None


def replay_log(
    base_participants: Dict[str, int],
    base_retired: Tuple[int, ...],
    entries: List[dict],
    from_epoch: int,
) -> Tuple[Dict[str, int], Tuple[int, ...]]:
    """Replay the log suffix with epoch > ``from_epoch`` on top of the
    base set, verifying each embedded signed transition.  Returns the
    resulting (participants, retired).  Raises ValueError on any
    malformed, mis-signed or inconsistent entry."""
    if len(entries) > MAX_LOG:
        raise ValueError(f"membership log too long ({len(entries)})")
    participants = dict(base_participants)
    retired = tuple(base_retired)
    epoch = from_epoch
    for entry in entries:
        err = check_log_entry(entry)
        if err is not None:
            raise ValueError(err)
        if entry["epoch"] <= from_epoch:
            continue   # the trusted base already includes this epoch
        if entry["epoch"] != epoch + 1:
            raise ValueError(
                f"membership log skips from epoch {epoch} to "
                f"{entry['epoch']}"
            )
        tx = parse_membership_tx(bytes(entry["tx"]))
        if tx is None:
            raise ValueError("membership log carries an unparseable tx")
        if (tx.kind, tx.pub_hex, tx.net_addr) != (
                entry["kind"], entry["pub"], entry["addr"]):
            # net_addr included: it is inside the subject-signed
            # message, and an unchecked entry['addr'] would let a
            # forged log redirect a validator's gossip address to an
            # attacker-chosen one (eclipse of that link)
            raise ValueError("membership log entry contradicts its tx")
        if tx.epoch > epoch or epoch - tx.epoch > PIPELINE_WINDOW:
            # pipelined transitions keep their submission-time stamp:
            # stamped at or before the epoch they apply FROM, within
            # the engine's queue bound
            raise ValueError(
                f"membership tx stamped epoch {tx.epoch}, applied at "
                f"epoch {epoch} (allowed window {PIPELINE_WINDOW})"
            )
        if not tx.verify():
            raise ValueError(
                f"membership tx for {tx.pub_hex[:18]}… has a bad "
                "subject signature"
            )
        if tx.kind == "join":
            if tx.pub_hex in participants:
                raise ValueError("membership log joins an existing member")
            participants[tx.pub_hex] = len(participants)
        else:
            cid = participants.get(tx.pub_hex)
            if cid is None or cid in retired:
                raise ValueError("membership log leaves a non-member")
            retired = retired + (cid,)
        epoch = entry["epoch"]
    return participants, retired


def verify_membership_chain(
    base_participants: Dict[str, int],
    base_retired: Tuple[int, ...],
    base_epoch: int,
    engine,
) -> Optional[str]:
    """Verify that ``engine``'s claimed peer set is exactly what its
    membership log derives from our trusted base.  Returns an error
    string (reject the snapshot) or None."""
    snap_epoch = int(getattr(engine, "epoch", 0))
    if snap_epoch < base_epoch:
        return (
            f"snapshot epoch {snap_epoch} is behind our epoch "
            f"{base_epoch}"
        )
    trunc = int(getattr(engine, "membership_base_epoch", 0) or 0)
    if base_epoch < trunc:
        # bounded membership_log: the snapshot truncated the chain
        # entries our trusted base would need.  Same contract as the
        # rolling event window's TooLate — bootstrap from a fresher
        # trusted base (updated bootstrap peers.json) instead.
        return (
            f"snapshot membership log is truncated at epoch {trunc}, "
            f"above our trusted base epoch {base_epoch} — cannot "
            "bridge the chain of custody"
        )
    log = list(getattr(engine, "membership_log", ()) or ())
    try:
        participants, retired = replay_log(
            base_participants, base_retired, log, base_epoch
        )
    except ValueError as e:
        return f"membership chain invalid: {e}"
    if len(log) and log[-1]["epoch"] != snap_epoch:
        return (
            f"membership log ends at epoch {log[-1]['epoch']} but the "
            f"snapshot claims epoch {snap_epoch}"
        )
    if not log and snap_epoch != base_epoch:
        return (
            f"snapshot claims epoch {snap_epoch} with no membership "
            "log to derive it"
        )
    if participants != engine.participants:
        return (
            "snapshot participant set does not match its own membership "
            f"chain ({len(engine.participants)} vs {len(participants)} "
            "entries)"
        )
    snap_retired = tuple(getattr(engine.cfg, "retired", ())) \
        if hasattr(engine, "cfg") else ()
    if tuple(sorted(retired)) != tuple(sorted(snap_retired)):
        return "snapshot retired set does not match its membership chain"
    return None
