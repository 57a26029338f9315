"""Peer bookkeeping (reference net/peer.go:32-157).

A peer is (net_addr, pub_key_hex).  Canonical participant ids are assigned
by sorting peers by public key hex (reference cmd/main.go + net.ByPubKey,
node/node.go:71-79): every node derives the same id map independently.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

PEERS_FILE = "peers.json"


@dataclass(frozen=True)
class Peer:
    net_addr: str
    pub_key_hex: str


def canonical_ids(peers: List[Peer]) -> Dict[str, int]:
    """pub hex -> participant id, identical on every node."""
    ordered = sorted(peers, key=lambda p: p.pub_key_hex)
    return {p.pub_key_hex: i for i, p in enumerate(ordered)}


def exclude_peer(peers: List[Peer], addr: str) -> tuple[int, List[Peer]]:
    """Drop the peer with net_addr == addr; returns (its index, rest)
    (reference net/peer.go:141-151)."""
    idx = -1
    rest = []
    for i, p in enumerate(peers):
        if p.net_addr == addr:
            idx = i
        else:
            rest.append(p)
    return idx, rest


def peers_from_file(path: str) -> List[Peer]:
    """Parse a peers.json-format file at an explicit path (the cli's
    --bootstrap_peers loader shares JSONPeers' schema — one format to
    evolve, not two)."""
    with open(path) as f:
        raw = json.load(f)
    return [
        Peer(net_addr=p["NetAddr"], pub_key_hex=p["PubKeyHex"]) for p in raw
    ]


class StaticPeers:
    """In-memory PeerStore (reference net/peer.go:44-66)."""

    def __init__(self, peers: Optional[List[Peer]] = None):
        self._lock = threading.Lock()
        self._peers = list(peers or [])

    def peers(self) -> List[Peer]:
        with self._lock:
            return list(self._peers)

    def set_peers(self, peers: List[Peer]) -> None:
        with self._lock:
            self._peers = list(peers)


class JSONPeers:
    """peers.json on disk in a datadir (reference net/peer.go:76-129)."""

    def __init__(self, datadir: str):
        self.path = os.path.join(datadir, PEERS_FILE)
        self._lock = threading.Lock()

    def peers(self) -> List[Peer]:
        with self._lock:
            with open(self.path) as f:
                raw = json.load(f)
        return [
            Peer(net_addr=p["NetAddr"], pub_key_hex=p["PubKeyHex"]) for p in raw
        ]

    def set_peers(self, peers: List[Peer]) -> None:
        raw = [
            {"NetAddr": p.net_addr, "PubKeyHex": p.pub_key_hex} for p in peers
        ]
        with self._lock:
            with open(self.path, "w") as f:
                json.dump(raw, f, indent=2)
