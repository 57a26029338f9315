"""Gossip partner selection (reference node/peer_selector.go:24-61): the
port's copy of the JAX package's ``node/peer_selector.py``, drawing the
same peers for the same address."""

from __future__ import annotations

import random
from typing import List, Optional

from ..net.peers import Peer, exclude_peer


class PeerSelector:
    def peers(self) -> List[Peer]:
        raise NotImplementedError

    def next(self) -> Optional[Peer]:
        raise NotImplementedError

    def update_last(self, peer_addr: str) -> None:
        raise NotImplementedError


class RandomPeerSelector(PeerSelector):
    """Uniform choice excluding self and the last-gossiped peer.

    The default RNG is seeded from the node's own address, NOT OS
    entropy (found by the consensus-nondeterminism taint pass): peer
    choice shapes the DAG, and an unseeded stream here was the last
    per-node decision the chaos plane could not replay from identity +
    seed alone.  Distinct nodes still draw distinct streams (different
    addresses), which is all the jitter was ever for; callers that
    genuinely want shared-seed control pass ``rng`` explicitly."""

    def __init__(self, peers: List[Peer], local_addr: str,
                 rng: Optional[random.Random] = None):
        _, self._peers = exclude_peer(peers, local_addr)
        self.local_addr = local_addr
        self.last: Optional[str] = None
        # string seeding is content-based (not hash()-randomized), so
        # the stream is stable across processes and PYTHONHASHSEED
        self._rng = rng if rng is not None else random.Random(
            f"peer-selector:{local_addr}")

    def peers(self) -> List[Peer]:
        return list(self._peers)

    def add_peer(self, peer: Peer) -> None:
        """Membership plane: admit a newly-joined validator as a
        gossip target (idempotent; self never added)."""
        if peer.net_addr == self.local_addr:
            return
        if any(p.net_addr == peer.net_addr for p in self._peers):
            return
        self._peers.append(peer)

    def remove_peer(self, addr: str) -> None:
        """Membership plane: stop gossiping to a departed validator."""
        _, self._peers = exclude_peer(self._peers, addr)
        if self.last == addr:
            self.last = None

    def next(self) -> Optional[Peer]:
        candidates = self._peers
        if len(candidates) > 1 and self.last is not None:
            _, candidates = exclude_peer(candidates, self.last)
        if not candidates:
            return None
        return self._rng.choice(candidates)

    def update_last(self, peer_addr: str) -> None:
        self.last = peer_addr
