"""Host-side DAG index: slot assignment, validation, levels, batch arrays
(the port's copy of the JAX package's ``core/dag.py``).

The host mirror of the device state: hash <-> slot resolution, insert
validation and per-creator chains.  Device slots are insertion order on
this replica; consensus outputs are replica-invariant because the
ordering keys (round received, median timestamp, whitened signature) do
not depend on slots.

Insert validation mirrors FromParentsLatest (reference
hashgraph.go:366-396): parents must exist and the self-parent must be
the creator's latest event, which rejects forks.

Levels: level(x) = 1 + max(level(sp), level(op)), 0 for roots.  Events
of one level are mutually non-ancestral, which is what lets the device
ingest process a level per step.

Bounded memory: every per-slot sequence is an ``OffsetList``; committed
prefixes are evicted (``evict_prefix``) in lockstep with the device
window, and reads below the window raise ``TooLateError``.  Wire
parent coordinates are captured at insert (``wire_meta``), so
``to_wire`` never needs an evicted parent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common import OffsetList
from ..crypto.keys import pub_hex_to_bytes
from .event import Event, EventBody, WireEvent


class InsertError(ValueError):
    pass


#: width of the per-event claimed-timestamp window (adversarial-timestamp
#: defense): a claimed timestamp is clamped at insert into
#: ``[parent_max + 1, parent_max + WINDOW]``, ``parent_max`` being the
#: max effective timestamp of the event's known parents.  Honest traffic
#: never reaches either edge, so effective == claimed on an honest fleet.
TS_CLAMP_WINDOW_NS = 600_000_000_000  # 10 min of ns


def clamp_eff_ts(claimed: int, parent_ref: Optional[int]) -> int:
    """Effective timestamp of an event claiming ``claimed`` whose known
    parents' max effective timestamp is ``parent_ref`` (``None`` for
    roots and pseudo-roots)."""
    if parent_ref is None:
        return claimed
    return min(max(claimed, parent_ref + 1), parent_ref + TS_CLAMP_WINDOW_NS)


@dataclass
class HostDag:
    participants: Dict[str, int]              # pub hex -> id
    verify_signatures: bool = True

    reverse_participants: Dict[int, str] = field(init=False)
    events: OffsetList = field(default_factory=OffsetList)     # by slot
    slot_of: Dict[str, int] = field(default_factory=dict)      # hex -> slot
    levels: OffsetList = field(default_factory=OffsetList)     # by slot
    sp_slot: OffsetList = field(default_factory=OffsetList)
    op_slot: OffsetList = field(default_factory=OffsetList)
    # (sp_index, op_creator_id, op_index) by slot: the wire coordinates,
    # captured at insert so they survive parent eviction
    wire_meta: OffsetList = field(default_factory=OffsetList)
    # effective (clamped) timestamp by slot: what the device medians read
    eff_ts: OffsetList = field(default_factory=OffsetList)
    chains: List[OffsetList] = field(init=False)               # creator -> slots
    pending: List[int] = field(default_factory=list)           # unflushed slots
    # per-creator eviction horizon: cid -> (index, hex) of the newest
    # evicted event of that creator; a continuation naming it as
    # self-parent at index + 1 inserts as a pseudo-root
    evicted_heads: Dict[int, Tuple[int, str]] = field(default_factory=dict)

    def __post_init__(self):
        self.reverse_participants = {v: k for k, v in self.participants.items()}
        self.chains = [OffsetList() for _ in range(len(self.participants))]

    @property
    def n(self) -> int:
        return len(self.participants)

    @property
    def n_events(self) -> int:
        """Total events ever inserted (next slot number)."""
        return len(self.events)

    @property
    def slot_base(self) -> int:
        """First non-evicted slot (== the device state's e_off)."""
        return self.events.start

    def add_participant(self, pub_hex: str) -> int:
        """Admit a new creator at the next free participant id (ids of
        existing creators stay: renumbering would scramble every
        creator-indexed column).  Called only at an epoch boundary
        (``TorchHashgraph.apply_epoch_transition``); returns the id."""
        if pub_hex in self.participants:
            raise ValueError(f"participant {pub_hex[:18]}… already known")
        cid = len(self.participants)
        self.participants[pub_hex] = cid
        self.reverse_participants[cid] = pub_hex
        self.chains.append(OffsetList())
        return cid

    # ------------------------------------------------------------------

    def insert(self, event: Event) -> int:
        """Validate and index one event; returns its slot."""
        creator = event.creator
        cid = self.participants.get(creator)
        if cid is None:
            raise InsertError(f"unknown participant {creator[:18]}…")
        if (self.verify_signatures and not event.chain_verified
                and not event.verify()):
            raise InsertError("invalid signature")

        sp, op = event.self_parent, event.other_parent
        chain = self.chains[cid]
        if sp == "" and op == "" and not chain:
            if event.index != 0:
                raise InsertError(
                    f"root event must have index 0, got {event.index}"
                )
            sps = ops = -1
            meta = (-1, -1, -1)
        else:
            sps = self.slot_of.get(sp, -1)
            continuation = False
            if sps < 0:
                # post-horizon chain continuation: when inactivity
                # eviction emptied this creator's whole window, an event
                # naming exactly the recorded horizon hash as self-parent
                # at the next index resumes the chain as a pseudo-root
                horizon = self.evicted_heads.get(cid)
                if (not chain.window and horizon is not None
                        and sp != "" and horizon == (event.index - 1, sp)
                        and event.index == len(chain)):
                    continuation = True
                else:
                    raise InsertError(
                        f"self-parent not known (creator already has "
                        f"{len(chain)} events — possible fork)"
                        if sp == ""
                        else f"self-parent not known ({sp[:18]}…)"
                    )
            if not continuation and self.events[sps].creator != creator:
                raise InsertError("self-parent has different creator")
            ops = self.slot_of.get(op, -1)
            if ops < 0:
                # non-root events need both parents (hashgraph.go:381-384)
                raise InsertError(f"other-parent not known ({op[:18]}…)")
            if not continuation and (not chain or chain[-1] != sps):
                raise InsertError("self-parent not last known event by creator")
            if event.index != len(chain):
                raise InsertError(
                    f"bad sequence index {event.index}, expected {len(chain)}"
                )
            op_ev = self.events[ops]
            meta = (
                event.index - 1 if continuation else self.events[sps].index,
                self.participants[op_ev.creator],
                op_ev.index,
            )

        hex_id = event.hex()
        if hex_id in self.slot_of:
            raise InsertError("duplicate event")

        slot = len(self.events)
        event.topological_index = slot
        level = 0
        if sps >= 0 or ops >= 0:
            level = 1 + max(
                self.levels[sps] if sps >= 0 else -1,
                self.levels[ops] if ops >= 0 else -1,
            )
        # the claimed timestamp clamped into the window over the parents'
        # effective timestamps; parents outside the window contribute
        # nothing
        claimed = event.body.timestamp
        parent_ref = None
        if sps >= 0:
            parent_ref = self.eff_ts[sps]
        if ops >= 0:
            op_eff = self.eff_ts[ops]
            parent_ref = op_eff if parent_ref is None \
                else max(parent_ref, op_eff)
        eff = clamp_eff_ts(claimed, parent_ref)
        self.events.append(event)
        self.slot_of[hex_id] = slot
        self.levels.append(level)
        self.sp_slot.append(sps)
        self.op_slot.append(ops)
        self.wire_meta.append(meta)
        self.eff_ts.append(eff)
        chain.append(slot)
        self.pending.append(slot)
        return slot

    # ------------------------------------------------------------------

    def evict_prefix(self, new_base: int) -> None:
        """Drop every slot below ``new_base`` (the engine guarantees they are
        committed and outside every rolling window — see maybe_compact)."""
        for ev in self.events.evict_to(new_base):
            # slots ascend with seq within a chain, so the last write per
            # creator records its newest evicted event
            self.evicted_heads[self.participants[ev.creator]] = (
                ev.index, ev.hex()
            )
            del self.slot_of[ev.hex()]
        self.levels.evict_to(new_base)
        self.sp_slot.evict_to(new_base)
        self.op_slot.evict_to(new_base)
        self.wire_meta.evict_to(new_base)
        self.eff_ts.evict_to(new_base)
        for chain in self.chains:
            w = chain.window
            # chain slots ascend, so the evicted part is a prefix
            k = 0
            while k < len(w) and w[k] < new_base:
                k += 1
            chain.evict_to(chain.start + k)

    # ------------------------------------------------------------------

    def take_pending(self) -> Tuple[np.ndarray, ...]:
        """Drain pending slots into batch arrays + a level-grouped schedule.

        Returns (sp, op, creator, seq, ts, mbit, sched) as numpy arrays with
        *device-local* parent slots (global - slot_base); sched holds batch
        positions (0-based within this batch), -1 padding.
        """
        batch = self.peek_pending()
        self.pending = []
        return batch

    def drop_pending(self) -> None:
        """Drain the pending queue after a successful peek_pending."""
        self.pending = []

    def peek_pending(self) -> Tuple[np.ndarray, ...]:
        """take_pending's array build without draining the queue."""
        slots = self.pending
        base = self.slot_base
        k = len(slots)
        sp = np.empty(k, np.int32)
        op = np.empty(k, np.int32)
        creator = np.empty(k, np.int32)
        seq = np.empty(k, np.int32)
        ts = np.empty(k, np.int64)
        mbit = np.empty(k, bool)
        lev = np.empty(k, np.int64)
        for i, s in enumerate(slots):
            ev = self.events[s]
            sps, ops = self.sp_slot[s], self.op_slot[s]
            sp[i] = sps - base if sps >= 0 else -1
            op[i] = ops - base if ops >= 0 else -1
            creator[i] = self.participants[ev.creator]
            seq[i] = ev.index
            # the clamped effective timestamp, not the raw claim
            ts[i] = self.eff_ts[s]
            mbit[i] = ev.middle_bit()
            lev[i] = self.levels[s]

        # group batch positions by level
        order = np.argsort(lev, kind="stable")
        ulev, starts = np.unique(lev[order], return_index=True)
        bounds = list(starts) + [k]
        t = len(ulev)
        b = max(int(np.max(np.diff(bounds))), 1) if t else 1
        sched = np.full((max(t, 1), b), -1, np.int32)
        for row in range(t):
            grp = order[bounds[row]: bounds[row + 1]]
            sched[row, : len(grp)] = grp
        return sp, op, creator, seq, ts, mbit, sched

    # ------------------------------------------------------------------
    # wire conversion (reference hashgraph.go:496-571)

    def to_wire(self, event: Event) -> WireEvent:
        sp_index, op_cid, op_index = self.wire_meta[self.slot_of[event.hex()]]
        return event.to_wire(
            sp_index, op_cid, op_index, self.participants[event.creator]
        )

    def read_wire_info(self, wevent: WireEvent,
                       overlay: Optional[dict] = None) -> Event:
        """Materialise a compact wire event, resolving its (creator,
        index) parent references.  ``overlay`` maps (cid, index) -> hex
        for events of the same batch that are converted but not yet
        inserted."""
        creator = self.reverse_participants[wevent.creator_id]
        cid = wevent.creator_id

        def resolve(rcid: int, idx: int) -> str:
            if overlay is not None:
                h = overlay.get((rcid, idx))
                if h is not None:
                    return h
            horizon = self.evicted_heads.get(rcid)
            if horizon is not None and horizon[0] == idx \
                    and idx < self.chains[rcid].start:
                # the referenced event was evicted, but its (index, hex)
                # survives as the creator's eviction horizon
                return horizon[1]
            return self.events[self.chains[rcid][idx]].hex()

        self_parent = ""
        other_parent = ""
        if wevent.self_parent_index >= 0:
            self_parent = resolve(cid, wevent.self_parent_index)
        if wevent.other_parent_index >= 0:
            other_parent = resolve(
                wevent.other_parent_creator_id, wevent.other_parent_index
            )
        body = EventBody(
            transactions=list(wevent.transactions),
            self_parent=self_parent,
            other_parent=other_parent,
            creator=pub_hex_to_bytes(creator),
            timestamp=wevent.timestamp,
            index=wevent.index,
        )
        return Event(body=body, r=wevent.r, s=wevent.s)

    def participant_events(self, creator: str, skip: int) -> List[str]:
        """Event hexes of ``creator`` with seq >= skip (the gossip diff
        unit, reference node/core.go:108-132); ``TooLateError`` when
        ``skip`` falls below the rolling window."""
        cid = self.participants[creator]
        return [self.events[s].hex() for s in self.chains[cid][skip:]]

    def known(self) -> Dict[int, int]:
        return {cid: len(chain) for cid, chain in enumerate(self.chains)}

    def last_from(self, creator: str) -> str:
        chain = self.chains[self.participants[creator]]
        return self.events[chain[-1]].hex() if chain else ""
