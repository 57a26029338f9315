"""Final consensus ordering (reference hashgraph/consensus_sorter.go), the
port's copy of the JAX package's ``consensus/ordering.py``.

Events with a decided round received are ordered by round received,
then consensus (median) timestamp, then the whitened signature
``s ^ prn(round_received)``, where prn is the XOR of the round's
famous-witness hashes (reference roundInfo.go:109-118).
"""

from __future__ import annotations

from typing import Callable, List

from ..core.event import Event


def consensus_sort(events: List[Event], prn_for_round: Callable[[int], int]) -> List[Event]:
    prn_cache = {}

    def prn(r: int) -> int:
        if r not in prn_cache:
            prn_cache[r] = prn_for_round(r)
        return prn_cache[r]

    def key(e: Event):
        rr = e.round_received if e.round_received is not None else -1
        return (rr, e.consensus_timestamp, e.s ^ prn(rr))

    return sorted(events, key=key)
