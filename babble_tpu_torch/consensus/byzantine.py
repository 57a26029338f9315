"""Fork-aware consensus oracle: the semantic anchor for byzantine mode
(the port's copy of the JAX package's ``consensus/byzantine.py``).

The reference sidesteps forks entirely — `FromParentsLatest` rejects any
event whose self-parent is not the creator's latest (hashgraph.go:366-396)
and `See` explicitly skips fork detection (hashgraph.go:149-154).  The
BASELINE byzantine config (1024 nodes, 1/3 forking) needs the real thing,
so the semantics here come from the hashgraph paper's definitions, chosen
to coincide exactly with the reference pipeline on fork-free DAGs (the
differential tests assert both directions):

- fork(w, z): same creator, neither is a self-ancestor of the other.
- see(x, y): y is an ancestor of x AND x's ancestry contains no fork pair
  by y's creator.  (On honest DAGs this degrades to plain ancestry.)
- strongly_see(x, y): events by >= 2n/3+1 *creators* w with see(x, w) and
  see(w, y).
- round/witness/fame/round-received: the reference recursions on top of
  the fork-aware predicates, with per-creator deduplication where the
  reference counted participants.  A forking creator can have several
  witnesses per round (one per branch); Baird's strongly-seeing lemma
  guarantees no two of them are ever both strongly seen by anyone, which
  keeps vote tallies well-defined.

Everything is computed definition-first from explicit ancestor sets —
deliberately the slow-but-obviously-correct formulation the dense branch
kernels (ops/forks.py) are differentially tested against.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..core.dag import clamp_eff_ts
from ..core.event import Event, middle_bit
from ..quorum import supermajority
from .ordering import consensus_sort


class ByzantineInsertError(ValueError):
    pass


@dataclass
class ForkOracle:
    participants: Dict[str, int]              # pub hex -> id
    verify_signatures: bool = False

    events: Dict[str, Event] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)       # insertion order
    anc: Dict[str, Set[str]] = field(default_factory=dict)   # incl. self
    self_anc: Dict[str, Set[str]] = field(default_factory=dict)
    by_creator: Dict[int, List[str]] = field(default_factory=dict)
    _round: Dict[str, int] = field(default_factory=dict)
    famous: Dict[str, Optional[bool]] = field(default_factory=dict)
    rr: Dict[str, int] = field(default_factory=dict)
    cts: Dict[str, int] = field(default_factory=dict)
    consensus: List[str] = field(default_factory=list)
    lcr: int = -1
    # fork pairs per creator, filled lazily as events arrive
    _fork_pairs: Dict[int, List[Tuple[str, str]]] = field(default_factory=dict)
    #: clamp-enforced effective timestamps (adversarial-ts defense) —
    #: the values the consensus-timestamp median consumes, mirroring
    #: ops/forks.py ForkDag.eff_ts so the oracle stays the differential
    #: ground truth under lying-timestamp attacks
    _eff_ts: Dict[str, int] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.participants)

    @property
    def super_majority(self) -> int:
        return supermajority(self.n)

    # ------------------------------------------------------------------

    def insert_event(self, event: Event) -> None:
        """Fork-tolerant insert: parents must exist and the self-parent
        must belong to the same creator at index-1, but it need NOT be the
        creator's latest — that is exactly what a fork is."""
        x = event.hex()
        if x in self.events:
            raise ByzantineInsertError("duplicate event")
        cid = self.participants.get(event.creator)
        if cid is None:
            raise ByzantineInsertError("unknown participant")
        if self.verify_signatures and not event.verify():
            raise ByzantineInsertError("invalid signature")
        sp, op = event.self_parent, event.other_parent
        if sp == "" and op == "":
            if event.index != 0:
                raise ByzantineInsertError("root must have index 0")
            self.anc[x] = {x}
            self.self_anc[x] = {x}
        else:
            spe = self.events.get(sp)
            if spe is None:
                raise ByzantineInsertError("self-parent not known")
            if spe.creator != event.creator:
                raise ByzantineInsertError("self-parent has different creator")
            if event.index != spe.index + 1:
                raise ByzantineInsertError("bad index")
            ope = self.events.get(op)
            if ope is None:
                raise ByzantineInsertError("other-parent not known")
            self.anc[x] = {x} | self.anc[sp] | self.anc[op]
            self.self_anc[x] = {x} | self.self_anc[sp]

        # fork bookkeeping: x forks with every same-creator event that is
        # neither its self-ancestor nor its self-descendant
        prior = self.by_creator.setdefault(cid, [])
        pairs = self._fork_pairs.setdefault(cid, [])
        for z in prior:
            if z not in self.self_anc[x] and x not in self.self_anc[z]:
                pairs.append((x, z))
        prior.append(x)

        # per-creator eff-ts clamp, identical to ForkDag.insert — refs
        # are the parents' EFFECTIVE values, absent parents contribute
        # nothing (pseudo-roots keep their claim)
        refs = [self._eff_ts[p] for p in (sp, op) if p in self._eff_ts]
        self._eff_ts[x] = clamp_eff_ts(
            event.body.timestamp, max(refs) if refs else None
        )

        self.events[x] = event
        self.order.append(x)
        self.famous[x] = None

    # ------------------------------------------------------------------
    # predicates (hashgraph paper definitions)

    def ancestor(self, x: str, y: str) -> bool:
        return y in self.anc.get(x, ())

    def detects_fork(self, x: str, cid: int) -> bool:
        ax = self.anc[x]
        return any(
            w in ax and z in ax for w, z in self._fork_pairs.get(cid, ())
        )

    def see(self, x: str, y: str) -> bool:
        if y not in self.anc.get(x, ()):
            return False
        cy = self.participants[self.events[y].creator]
        return not self.detects_fork(x, cy)

    def strongly_see(self, x: str, y: str) -> bool:
        seen_creators = set()
        for w in self.anc[x]:
            cw = self.participants[self.events[w].creator]
            if cw in seen_creators:
                continue
            if self.see(x, w) and self.see(w, y):
                seen_creators.add(cw)
        return len(seen_creators) >= self.super_majority

    # ------------------------------------------------------------------
    # rounds

    def round(self, x: str) -> int:
        r = self._round.get(x)
        if r is not None:
            return r
        ev = self.events[x]
        sp, op = ev.self_parent, ev.other_parent
        if sp == "" and op == "":
            pr = 0
        else:
            pr = max(self.round(sp), self.round(op))
            creators = set()
            for w, rw in self._round.items():
                if rw == pr and self.witness(w) and self.strongly_see(x, w):
                    creators.add(self.participants[self.events[w].creator])
            if len(creators) >= self.super_majority:
                pr += 1
        self._round[x] = pr
        return pr

    def witness(self, x: str) -> bool:
        ev = self.events[x]
        if ev.self_parent == "":
            return True
        return self.round(x) > self.round(ev.self_parent)

    def divide_rounds(self) -> None:
        for x in self.order:
            self.round(x)

    def max_round(self) -> int:
        return max(self._round.values(), default=-1)

    def round_witnesses(self, r: int) -> List[str]:
        return [
            x for x in self.order
            if self._round.get(x) == r and self.witness(x)
        ]

    # ------------------------------------------------------------------
    # fame (reference DecideFame recursion over fork-aware predicates,
    # per-creator vote tallies)

    def decide_fame(self) -> None:
        self.divide_rounds()
        votes: Dict[Tuple[str, str], bool] = {}
        max_r = self.max_round()
        wits = {r: self.round_witnesses(r) for r in range(max_r + 1)}

        # scan from round 0, not lcr+1: lcr advances past undecided rounds
        # (skip semantics), so a witness left undecided below lcr must be
        # revisited on later calls — the dense engine recomputes fame from
        # scratch and would otherwise diverge under incremental use.
        # Already-decided witnesses short-circuit below.
        for i in range(0, max_r + 1):
            for x in wits.get(i, []):
                if self.famous[x] is not None:
                    continue
                for j in range(i + 1, max_r + 1):
                    for y in wits.get(j, []):
                        if j == i + 1:
                            votes[(y, x)] = self.see(y, x)
                        else:
                            # per-creator majority among strongly-seen
                            # round j-1 witnesses (the strongly-seeing
                            # lemma makes the creator vote unique)
                            yays = nays = 0
                            seen: Set[int] = set()
                            for w in wits.get(j - 1, []):
                                if not self.strongly_see(y, w):
                                    continue
                                cw = self.participants[
                                    self.events[w].creator
                                ]
                                if cw in seen:
                                    continue
                                seen.add(cw)
                                if votes.get((w, x), False):
                                    yays += 1
                                else:
                                    nays += 1
                            v = yays >= nays
                            t = max(yays, nays)
                            if (j - i) % self.n != 0:
                                if t >= self.super_majority:
                                    self.famous[x] = v
                                    votes[(y, x)] = v
                                    break
                                votes[(y, x)] = v
                            else:  # coin round
                                if t >= self.super_majority:
                                    votes[(y, x)] = v
                                else:
                                    votes[(y, x)] = middle_bit(
                                        self.events[y].hash()
                                    )
                    if self.famous[x] is not None:
                        break

        # advance last consensus round
        for i in range(self.lcr + 1, max_r + 1):
            ws = wits.get(i, [])
            if ws and all(self.famous[w] is not None for w in ws):
                self.lcr = max(self.lcr, i)
            # undecided rounds are skipped, not break points — matches
            # the reference's per-round scan

    # ------------------------------------------------------------------
    # order

    def oldest_self_ancestor_to_see(self, w: str, x: str) -> str:
        cur = w
        while True:
            sp = self.events[cur].self_parent
            if sp == "" or not self.see(sp, x):
                return cur
            cur = sp

    def find_order(self) -> List[Event]:
        self.decide_fame()
        max_r = self.max_round()
        decided = {}
        for r in range(max_r + 1):
            ws = self.round_witnesses(r)
            decided[r] = bool(ws) and all(
                self.famous[w] is not None for w in ws
            )
        newly: List[Event] = []
        for x in self.order:
            if x in self.rr:
                continue
            for i in range(self.round(x) + 1, max_r + 1):
                if not decided.get(i):
                    continue
                fam = [
                    w for w in self.round_witnesses(i) if self.famous[w]
                ]
                s = [w for w in fam if self.see(w, x)]
                if len(s) > len(fam) // 2:
                    self.rr[x] = i
                    # effective (clamped) timestamps, like ForkDag's
                    # build_batch ts feed — never the signed claims
                    ts = sorted(
                        self._eff_ts.get(
                            h, self.events[h].body.timestamp
                        )
                        for h in (
                            self.oldest_self_ancestor_to_see(w, x)
                            for w in s
                        )
                    )
                    self.cts[x] = ts[len(ts) // 2]
                    ev = self.events[x]
                    ev.round_received = i
                    ev.consensus_timestamp = self.cts[x]
                    newly.append(ev)
                    break

        def prn(r: int) -> int:
            res = 0
            for w in self.round_witnesses(r):
                if self.famous[w]:
                    res ^= int(w, 16)
            return res

        newly = consensus_sort(newly, prn)
        self.consensus.extend(ev.hex() for ev in newly)
        return newly

    def run_consensus(self) -> List[Event]:
        return self.find_order()

    def consensus_events(self) -> List[str]:
        return list(self.consensus)
