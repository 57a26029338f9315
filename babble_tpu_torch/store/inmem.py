"""In-memory store: the reference's 14-method Store seam
(hashgraph/inmem_store.go, hashgraph/caches.go, hashgraph/roundInfo.go)
over the host state the engines index (the port's copy of the JAX
package's ``store/inmem.py``).

Event storage, per-creator chain views, rolling windows and the TooLate
contract live in ``core/dag.py``'s ``HostDag``; the oracle reads them
through this Store facade.  What remains here is the annex the oracle
needs and the device engines keep elsewhere: ``RoundInfo`` fame maps
(the device twin is the wslot/famous tensors) and the rolling consensus
log.

Eviction is prefix-based at cache_size: on this append-only workload
insertion order is the LRU order, and prefix eviction is the
``OffsetList`` window contract the engine's compaction drives
(caches.go:45-76) -- reads below the window raise ``TooLateError``
either way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol

from ..common import LRU, KeyNotFoundError, RollingList, TooLateError
from ..core.event import Event


@dataclass
class RoundEvent:
    """Witness flag + fame trilean for one event in a round
    (reference roundInfo.go:38-41; Famous None=Undefined/True/False)."""

    witness: bool = False
    famous: Optional[bool] = None


@dataclass
class RoundInfo:
    """Per-round event map (reference roundInfo.go:43-118)."""

    events: Dict[str, RoundEvent] = field(default_factory=dict)

    def add_event(self, x: str, witness: bool) -> None:
        if x not in self.events:
            self.events[x] = RoundEvent(witness=witness)

    def set_fame(self, x: str, famous: bool) -> None:
        ev = self.events.get(x)
        if ev is None:
            ev = RoundEvent(witness=True)
            self.events[x] = ev
        ev.famous = famous

    def witnesses_decided(self) -> bool:
        return all(
            not e.witness or e.famous is not None for e in self.events.values()
        )

    def witnesses(self) -> List[str]:
        return [x for x, e in self.events.items() if e.witness]

    def famous_witnesses(self) -> List[str]:
        return [x for x, e in self.events.items() if e.witness and e.famous is True]

    def pseudo_random_number(self) -> int:
        """XOR of famous witness hashes (reference roundInfo.go:109-118) —
        the whitening seed for the signature tiebreak."""
        res = 0
        for x in self.famous_witnesses():
            res ^= int(x, 16)
        return res


class Store(Protocol):
    """The 14-method persistence seam (reference store.go:25-41)."""

    def cache_size(self) -> int: ...
    def get_event(self, key: str) -> Event: ...
    def set_event(self, event: Event) -> None: ...
    def participant_events(self, participant: str, skip: int) -> List[str]: ...
    def participant_event(self, participant: str, index: int) -> str: ...
    def last_from(self, participant: str) -> str: ...
    def known(self) -> Dict[int, int]: ...
    def consensus_events(self) -> List[str]: ...
    def consensus_events_count(self) -> int: ...
    def add_consensus_event(self, key: str) -> None: ...
    def get_round(self, r: int) -> RoundInfo: ...
    def set_round(self, r: int, info: RoundInfo) -> None: ...
    def rounds(self) -> int: ...
    def round_witnesses(self, r: int) -> List[str]: ...
    def round_events(self, r: int) -> int: ...


class InmemStore:
    """The host-side Store (reference inmem_store.go:20-142), backed by
    ``core.dag.HostDag`` (module docstring)."""

    def __init__(self, participants: Dict[str, int], cache_size: int,
                 dag=None):
        from ..core.dag import HostDag

        self._cache_size = cache_size
        self.participants = participants
        # signature checks are the engines' concern (the oracle and
        # TorchHashgraph gate them before set_event/insert)
        self.dag = dag if dag is not None else HostDag(
            participants, verify_signatures=False
        )
        self._round_cache = LRU(cache_size)
        self._consensus_cache = RollingList(cache_size)

    def cache_size(self) -> int:
        return self._cache_size

    def get_event(self, key: str) -> Event:
        s = self.dag.slot_of.get(key)
        if s is None:
            raise KeyNotFoundError(key)
        return self.dag.events[s]

    def set_event(self, event: Event) -> None:
        if event.hex() in self.dag.slot_of:
            return          # annotation update; objects are shared
        self.dag.insert(event)
        # no device consumer behind this seam; don't grow the queue
        self.dag.pending.clear()
        live = self.dag.n_events - self.dag.slot_base
        if live > self._cache_size:
            self.dag.evict_prefix(self.dag.n_events - self._cache_size)

    def participant_events(self, participant: str, skip: int) -> List[str]:
        if participant not in self.participants:
            raise KeyNotFoundError(participant)
        return self.dag.participant_events(participant, skip)

    def participant_event(self, participant: str, index: int) -> str:
        cid = self.participants.get(participant)
        if cid is None:
            raise KeyNotFoundError(participant)
        chain = self.dag.chains[cid]
        if index >= len(chain):
            raise KeyNotFoundError((participant, index))
        return self.dag.events[chain[index]].hex()

    def last_from(self, participant: str) -> str:
        if participant not in self.participants:
            raise KeyNotFoundError(participant)
        return self.dag.last_from(participant)

    def known(self) -> Dict[int, int]:
        return self.dag.known()

    def consensus_events(self) -> List[str]:
        window, _ = self._consensus_cache.get()
        return list(window)

    def consensus_events_count(self) -> int:
        return self._consensus_cache.total

    def add_consensus_event(self, key: str) -> None:
        self._consensus_cache.add(key)

    def get_round(self, r: int) -> RoundInfo:
        info, ok = self._round_cache.get(r)
        if not ok:
            raise KeyNotFoundError(r)
        return info

    def set_round(self, r: int, info: RoundInfo) -> None:
        self._round_cache.add(r, info)

    def rounds(self) -> int:
        return len(self._round_cache)

    def round_witnesses(self, r: int) -> List[str]:
        try:
            return self.get_round(r).witnesses()
        except KeyNotFoundError:
            return []

    def round_events(self, r: int) -> int:
        try:
            return len(self.get_round(r).events)
        except KeyNotFoundError:
            return 0
