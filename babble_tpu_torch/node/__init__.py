"""Node runtime: the per-participant event loop around the consensus engine
(the port's copy of the JAX package's ``node``).

Async mirror of the reference's ``node/`` package: a single task
multiplexing inbound sync RPCs, heartbeat-paced gossip, app transaction
submissions, and commit batches (node/node.go:119-147), around a Core
owning one hashgraph + signing key (node/core.go).  The engine runs on
``Config.device`` ("cuda" unless the caller asks for the CPU).
"""

from .config import Config
from .core import Core
from .node import Node
from .peer_selector import PeerSelector, RandomPeerSelector

__all__ = ["Config", "Core", "Node", "PeerSelector", "RandomPeerSelector"]
