"""Epoch-aware quorum arithmetic — the port's copy of the JAX package's
``membership/quorum.py``, at the same path, the ONE place thresholds live.

A leaf module (standard library only): the port keeps its own copy so
that it imports nothing of the JAX package.  Every threshold routes
through these helpers with the epoch's active participant count, never
a stale ``n``; the ``stale-quorum-math`` babble-lint rule
(``analysis/quorummath.py``) flags any inlined form outside this file.
"""

from __future__ import annotations


def supermajority(n: int) -> int:
    """Witness/vote supermajority: more than two thirds of the active
    set (reference hashgraph.go ``superMajority``).  Strongly-seeing
    quorums, fame vote strength and round-increment thresholds all use
    this."""
    return 2 * n // 3 + 1


def sync_quorum(n: int) -> int:
    """Peer answers that, counting ourselves, form a supermajority."""
    return 2 * n // 3


def attestation_quorum(n: int) -> int:
    """Matching signed commit digests required to adopt a fast-forward
    snapshot (responder included): with fewer than a third of the
    active set byzantine, any such set contains an honest signer."""
    return n // 3 + 1


def coin_period(n: int) -> int:
    """Coin-round cadence of the fame vote recursion (reference
    hashgraph.go:643)."""
    return max(n, 1)
