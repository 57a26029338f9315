"""Reference-faithful hashgraph consensus engine in straight-line Python
(the port's copy of the JAX package's ``consensus/oracle.py``).

The differential-test anchor of the device engines: every predicate and
pipeline stage mirrors the reference's semantics (hashgraph/hashgraph.go),
evaluated hash by hash over a Store -- the slow formulation the dense
tensor engines replace.

Reference map:
- Ancestor/SelfAncestor/See          hashgraph.go:83-154
- OldestSelfAncestorToSee            hashgraph.go:157-177
- StronglySee                        hashgraph.go:180-208
- ParentRound/Witness/RoundInc/Round hashgraph.go:211-305
- InsertEvent + FromParentsLatest +
  InitEventCoordinates +
  UpdateAncestorFirstDescendant      hashgraph.go:328-494
- SetWireInfo/ReadWireInfo           hashgraph.go:496-571
- DivideRounds                       hashgraph.go:573-588
- DecideFame (virtual voting)        hashgraph.go:590-673
- DecideRoundReceived/FindOrder      hashgraph.go:676-760
- MedianTimestamp                    hashgraph.go:762-770

Deliberate divergences (documented, also honored by the device engines):
1. Fame decisions are sticky: once a witness's fame is decided it is never
   re-voted.  The reference re-enters decided (round, witness) pairs on later
   voting rounds with a partially-populated vote map, which can overwrite a
   decision when a single DecideFame call spans >=3 voting rounds past the
   decision point; its own fixtures never hit that window.
2. The final tiebreak uses the designed whitening (see ordering.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common import KeyNotFoundError
from ..core.event import Event, WireEvent, middle_bit
from ..crypto.keys import pub_hex_to_bytes
from ..store.inmem import RoundInfo, Store
from ..membership.quorum import supermajority
from .ordering import consensus_sort

_INT_MAX = np.iinfo(np.int64).max


@dataclass
class _Coords:
    """Per-event coordinate vectors: one slot per participant
    (reference event.go:82-83, EventCoordinates)."""

    la_index: np.ndarray            # int64[N] last-ancestor seq, -1 = none
    la_hash: List[str]
    fd_index: np.ndarray            # int64[N] first-descendant seq, INT_MAX = none
    fd_hash: List[str]


@dataclass
class OracleHashgraph:
    participants: Dict[str, int]            # pub hex -> id
    store: Store
    commit_callback: Optional[callable] = None
    verify_signatures: bool = True          # off for simulation-scale DAGs

    reverse_participants: Dict[int, str] = field(init=False)
    undetermined_events: List[str] = field(default_factory=list)
    last_consensus_round: Optional[int] = None
    last_committed_round_events: int = 0
    consensus_transactions: int = 0

    _topological_index: int = 0
    _coords: Dict[str, _Coords] = field(default_factory=dict)
    _round_memo: Dict[str, int] = field(default_factory=dict)
    _fame_decided: Dict[Tuple[int, str], bool] = field(default_factory=dict)
    _wire_info: Dict[str, Tuple[int, int, int, int]] = field(default_factory=dict)
    #: clamp-enforced effective timestamps (adversarial-ts defense) —
    #: the values _median_timestamp consumes, mirroring core/dag.py
    _eff_ts: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        self.reverse_participants = {v: k for k, v in self.participants.items()}

    # ------------------------------------------------------------------
    # basic quantities

    @property
    def n(self) -> int:
        return len(self.participants)

    def super_majority(self) -> int:
        return supermajority(self.n)

    # ------------------------------------------------------------------
    # reachability predicates (all O(1) via coordinate vectors)

    def ancestor(self, x: str, y: str) -> bool:
        """True if y is an ancestor of x (hashgraph.go:92-114)."""
        if x == "":
            return False
        if x == y:
            return True
        cx = self._coords.get(x)
        cy = self._event_or_none(y)
        if cx is None or cy is None:
            return False
        y_creator = self.participants[cy.creator]
        return int(cx.la_index[y_creator]) >= cy.index

    def self_ancestor(self, x: str, y: str) -> bool:
        if x == "":
            return False
        if x == y:
            return True
        ex = self._event_or_none(x)
        ey = self._event_or_none(y)
        if ex is None or ey is None:
            return False
        return ex.creator == ey.creator and ex.index >= ey.index

    def see(self, x: str, y: str) -> bool:
        # Fork detection is unnecessary because InsertEvent rejects forks
        # (reference hashgraph.go:148-154); the adversarial-fork extension
        # lives in the fork-aware pair (byzantine.py, fork_engine.py).
        return self.ancestor(x, y)

    def oldest_self_ancestor_to_see(self, x: str, y: str) -> str:
        """First event in x's self-chain that sees y (hashgraph.go:166-177)."""
        ex = self._event_or_none(x)
        cy = self._coords.get(y)
        if ex is None or cy is None:
            return ""
        xc = self.participants[ex.creator]
        if int(cy.fd_index[xc]) <= ex.index:
            return cy.fd_hash[xc]
        return ""

    def strongly_see(self, x: str, y: str) -> bool:
        """x strongly sees y: a supermajority of participants have an event
        that is an ancestor of x and a descendant of y (hashgraph.go:189-208).
        The elementwise formulation the device engines lift to (E, N)
        tensors."""
        cx = self._coords.get(x)
        cy = self._coords.get(y)
        if cx is None or cy is None:
            return False
        return int(np.count_nonzero(cx.la_index >= cy.fd_index)) >= self.super_majority()

    # ------------------------------------------------------------------
    # round logic

    def parent_round(self, x: str) -> int:
        if x == "":
            return -1
        ex = self._event_or_none(x)
        if ex is None:
            return -1
        if ex.self_parent == "" and ex.other_parent == "":
            return 0
        if self._event_or_none(ex.self_parent) is None:
            return 0
        if self._event_or_none(ex.other_parent) is None:
            return 0
        return max(self.round(ex.self_parent), self.round(ex.other_parent))

    def witness(self, x: str) -> bool:
        ex = self._event_or_none(x)
        if ex is None:
            return False
        if ex.self_parent == "":
            return True
        return self.round(x) > self.round(ex.self_parent)

    def round_inc(self, x: str) -> bool:
        if x == "":
            return False
        parent_round = self.parent_round(x)
        if parent_round < 0:
            return False
        if self.store.rounds() < parent_round + 1:
            return False
        c = sum(
            1
            for w in self.store.round_witnesses(parent_round)
            if self.strongly_see(x, w)
        )
        return c >= self.super_majority()

    def round(self, x: str) -> int:
        r = self._round_memo.get(x)
        if r is None:
            r = self.parent_round(x) + (1 if self.round_inc(x) else 0)
            self._round_memo[x] = r
        return r

    def round_diff(self, x: str, y: str) -> int:
        if x == "" or y == "":
            raise ValueError("round_diff on empty event")
        xr, yr = self.round(x), self.round(y)
        if xr < 0 or yr < 0:
            raise ValueError("event has negative round")
        return xr - yr

    # ------------------------------------------------------------------
    # insertion

    def insert_event(self, event: Event) -> None:
        """Verify -> validate parents -> assign topo index -> wire info ->
        coordinates -> store -> first-descendant backprop -> worklist
        (hashgraph.go:328-363)."""
        if self.verify_signatures and not event.verify():
            raise ValueError("invalid signature")

        self._check_from_parents_latest(event)

        event.topological_index = self._topological_index
        self._topological_index += 1

        self._set_wire_info(event)
        coords = self._init_event_coordinates(event)
        self.store.set_event(event)
        self._coords[event.hex()] = coords
        self._update_ancestor_first_descendant(event, coords)
        # adversarial-ts defense: the same per-creator timestamp clamp
        # the device engines apply at insert (core/dag.py) — medians
        # must read the identical effective values or the oracle stops
        # being the differential ground truth
        from ..core.dag import TS_CLAMP_WINDOW_NS

        claimed = event.body.timestamp
        refs = [self._eff_ts[p] for p in
                (event.self_parent, event.other_parent)
                if p in self._eff_ts]
        if refs:
            ref = max(refs)
            self._eff_ts[event.hex()] = min(
                max(claimed, ref + 1), ref + TS_CLAMP_WINDOW_NS
            )
        else:
            self._eff_ts[event.hex()] = claimed

        self.undetermined_events.append(event.hex())

    def _check_from_parents_latest(self, event: Event) -> None:
        """Parents must be the latest known events of their creators —
        the implicit fork rejection (hashgraph.go:366-396)."""
        creator = event.creator
        if creator not in self.participants:
            raise ValueError(f"unknown participant {creator[:18]}…")
        sp, op = event.self_parent, event.other_parent
        creator_known = self.store.known().get(self.participants[creator], 0)
        if sp == "" and op == "" and creator_known == 0:
            return
        sp_event = self._event_or_none(sp)
        if sp_event is None:
            raise ValueError(f"self-parent not known ({sp[:18]}…)")
        if sp_event.creator != creator:
            raise ValueError("self-parent has different creator")
        if self._event_or_none(op) is None:
            raise ValueError(f"other-parent not known ({op[:18]}…)")
        if sp != self.store.last_from(creator):
            raise ValueError("self-parent not last known event by creator")

    def _init_event_coordinates(self, event: Event) -> _Coords:
        """Element-wise max-merge of parents' last-ancestor vectors; own slot
        set to (index, hash) in both vectors (hashgraph.go:399-463)."""
        n = self.n
        fd_index = np.full(n, _INT_MAX, dtype=np.int64)
        fd_hash = [""] * n

        sp, op = event.self_parent, event.other_parent
        if sp == "" and op == "":
            la_index = np.full(n, -1, dtype=np.int64)
            la_hash = [""] * n
        elif sp == "":
            c = self._coords[op]
            la_index, la_hash = c.la_index.copy(), list(c.la_hash)
        elif op == "":
            c = self._coords[sp]
            la_index, la_hash = c.la_index.copy(), list(c.la_hash)
        else:
            cs, co = self._coords[sp], self._coords[op]
            la_index = cs.la_index.copy()
            la_hash = list(cs.la_hash)
            take = co.la_index > la_index
            la_index = np.where(take, co.la_index, la_index)
            for i in np.nonzero(take)[0]:
                la_hash[i] = co.la_hash[i]

        cid = self.participants[event.creator]
        la_index[cid] = event.index
        la_hash[cid] = event.hex()
        fd_index[cid] = event.index
        fd_hash[cid] = event.hex()
        return _Coords(la_index, la_hash, fd_index, fd_hash)

    def _update_ancestor_first_descendant(self, event: Event, coords: _Coords) -> None:
        """Walk each last-ancestor's self-chain setting this event as first
        descendant until a chain link already has one (hashgraph.go:466-494)."""
        cid = self.participants[event.creator]
        index, hash_ = event.index, event.hex()
        for i in range(self.n):
            ah = coords.la_hash[i]
            while ah != "":
                ac = self._coords.get(ah)
                if ac is None:
                    break
                if ac.fd_index[cid] == _INT_MAX:
                    ac.fd_index[cid] = index
                    ac.fd_hash[cid] = hash_
                    ev = self._event_or_none(ah)
                    ah = ev.self_parent if ev is not None else ""
                else:
                    break

    # ------------------------------------------------------------------
    # wire conversion (hashgraph.go:496-571)

    def _set_wire_info(self, event: Event) -> None:
        sp_index = -1
        op_creator_id = -1
        op_index = -1
        if event.self_parent != "":
            sp_index = self.store.get_event(event.self_parent).index
        if event.other_parent != "":
            op_ev = self.store.get_event(event.other_parent)
            op_creator_id = self.participants[op_ev.creator]
            op_index = op_ev.index
        self._wire_info[event.hex()] = (
            sp_index,
            op_creator_id,
            op_index,
            self.participants[event.creator],
        )

    def wire_info(self, hex_id: str) -> Tuple[int, int, int, int]:
        return self._wire_info[hex_id]

    def to_wire(self, event: Event) -> WireEvent:
        spi, opc, opi, cid = self._wire_info[event.hex()]
        return event.to_wire(spi, opc, opi, cid)

    def read_wire_info(self, wevent: WireEvent) -> Event:
        """Resolve (creatorID, index) ints back to hashes via the store's
        per-participant sequences (hashgraph.go:526-571)."""
        creator = self.reverse_participants[wevent.creator_id]
        self_parent = ""
        other_parent = ""
        if wevent.self_parent_index >= 0:
            self_parent = self.store.participant_event(
                creator, wevent.self_parent_index
            )
        if wevent.other_parent_index >= 0:
            other_creator = self.reverse_participants[wevent.other_parent_creator_id]
            other_parent = self.store.participant_event(
                other_creator, wevent.other_parent_index
            )
        from ..core.event import EventBody

        body = EventBody(
            transactions=list(wevent.transactions),
            self_parent=self_parent,
            other_parent=other_parent,
            creator=pub_hex_to_bytes(creator),
            timestamp=wevent.timestamp,
            index=wevent.index,
        )
        return Event(body=body, r=wevent.r, s=wevent.s)

    # ------------------------------------------------------------------
    # consensus pipeline

    def divide_rounds(self) -> None:
        """Assign (round, witness) to every undetermined event
        (hashgraph.go:573-588)."""
        for x in self.undetermined_events:
            round_number = self.round(x)
            witness = self.witness(x)
            try:
                info = self.store.get_round(round_number)
            except KeyNotFoundError:
                info = RoundInfo()
            info.add_event(x, witness)
            self.store.set_round(round_number, info)

    def _fame_loop_start(self) -> int:
        if self.last_consensus_round is not None:
            return self.last_consensus_round + 1
        return 0

    def decide_fame(self) -> None:
        """Virtual voting (hashgraph.go:598-664), with sticky decisions."""
        votes: Dict[str, Dict[str, bool]] = {}

        def vote_of(y: str, x: str) -> bool:
            return votes.get(y, {}).get(x, False)

        def set_vote(y: str, x: str, v: bool) -> None:
            votes.setdefault(y, {})[x] = v

        rounds_count = self.store.rounds()
        for i in range(self._fame_loop_start(), rounds_count - 1):
            info = self.store.get_round(i)
            for j in range(i + 1, rounds_count):
                for x in info.witnesses():
                    if info.events[x].famous is not None:
                        continue  # sticky decision (divergence note 1)
                    for y in self.store.round_witnesses(j):
                        diff = j - i
                        if diff == 1:
                            set_vote(y, x, self.see(y, x))
                            continue
                        ss_witnesses = [
                            w
                            for w in self.store.round_witnesses(j - 1)
                            if self.strongly_see(y, w)
                        ]
                        yays = sum(1 for w in ss_witnesses if vote_of(w, x))
                        nays = len(ss_witnesses) - yays
                        v = yays >= nays
                        t = yays if v else nays
                        if diff % self.n > 0:
                            # normal round
                            if t >= self.super_majority():
                                info.set_fame(x, v)
                                break  # next witness x
                            set_vote(y, x, v)
                        else:
                            # coin round: flip on the middle bit of y's hash
                            if t >= self.super_majority():
                                set_vote(y, x, v)
                            else:
                                set_vote(y, x, self._middle_bit(y))
            if info.witnesses_decided() and (
                self.last_consensus_round is None or i > self.last_consensus_round
            ):
                self._set_last_consensus_round(i)
            self.store.set_round(i, info)

    def _set_last_consensus_round(self, i: int) -> None:
        self.last_consensus_round = i
        self.last_committed_round_events = self.store.round_events(i - 1)

    def decide_round_received(self) -> None:
        """Round-received = first decided round whose famous witnesses
        majority-see the event; consensus timestamp = median over the oldest
        self-ancestors of those witnesses to see it (hashgraph.go:676-721)."""
        for x in self.undetermined_events:
            r = self.round(x)
            for i in range(r + 1, self.store.rounds()):
                try:
                    tr = self.store.get_round(i)
                except KeyNotFoundError:
                    continue
                if not tr.witnesses_decided():
                    continue
                fws = tr.famous_witnesses()
                s = [w for w in fws if self.see(w, x)]
                if len(s) > len(fws) // 2:
                    ex = self.store.get_event(x)
                    ex.round_received = i
                    t = [self.oldest_self_ancestor_to_see(a, x) for a in s]
                    ex.consensus_timestamp = self._median_timestamp(t)
                    self.store.set_event(ex)
                    break

    def find_order(self) -> List[Event]:
        """Partition undetermined events, sort the received ones, append to the
        consensus log, return the new batch (hashgraph.go:723-760)."""
        self.decide_round_received()

        new_consensus: List[Event] = []
        still_undetermined: List[str] = []
        for x in self.undetermined_events:
            ex = self.store.get_event(x)
            if ex.round_received is not None:
                new_consensus.append(ex)
            else:
                still_undetermined.append(x)
        self.undetermined_events = still_undetermined

        def prn(r: int) -> int:
            try:
                return self.store.get_round(r).pseudo_random_number()
            except KeyNotFoundError:
                return 0

        new_consensus = consensus_sort(new_consensus, prn)

        for e in new_consensus:
            self.store.add_consensus_event(e.hex())
            self.consensus_transactions += len(e.transactions)

        if self.commit_callback is not None and new_consensus:
            self.commit_callback(new_consensus)

        return new_consensus

    def run_consensus(self) -> List[Event]:
        self.divide_rounds()
        self.decide_fame()
        return self.find_order()

    # ------------------------------------------------------------------
    # helpers

    def consensus_events(self) -> List[str]:
        return self.store.consensus_events()

    def known(self) -> Dict[int, int]:
        return self.store.known()

    def _median_timestamp(self, hashes: List[str]) -> int:
        # effective (clamp-enforced) timestamps, not the raw claims —
        # the adversarial-ts defense's single seam, like dag.eff_ts
        ts = sorted(
            self._eff_ts.get(h, self.store.get_event(h).body.timestamp)
            for h in hashes
        )
        return ts[len(ts) // 2]

    def _middle_bit(self, hex_id: str) -> bool:
        return middle_bit(bytes.fromhex(hex_id[2:]))

    def _event_or_none(self, x: str) -> Optional[Event]:
        if x == "":
            return None
        try:
            return self.store.get_event(x)
        except KeyNotFoundError:
            return None
