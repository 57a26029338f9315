"""Quorum arithmetic — the port's copy of ``membership/quorum.py``'s
``supermajority``.

A leaf module (standard library only): the port keeps its own copy so
that it imports nothing of the JAX package.
"""

from __future__ import annotations


def supermajority(n: int) -> int:
    """Witness/vote supermajority: more than two thirds of the active
    set (reference hashgraph.go ``superMajority``).  Strongly-seeing
    quorums, fame vote strength and round-increment thresholds all use
    this."""
    return 2 * n // 3 + 1
