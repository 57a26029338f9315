"""The consensus engine (``engine.TorchHashgraph``), the fork-aware
(byzantine-mode) pair (``byzantine.ForkOracle``, the definition-first
oracle, and ``fork_engine.ForkHashgraph`` over ``ops/forks.py``), the
final ordering (``ordering``) and the rolling commit digest
(``digest``)."""

from .byzantine import ByzantineInsertError, ForkOracle
from .digest import CommitDigest, fold
from .engine import LATENCY_K_MAX, TorchHashgraph
from .fork_engine import ForkHashgraph
from .ordering import consensus_sort

__all__ = [
    "ByzantineInsertError", "CommitDigest", "ForkHashgraph", "ForkOracle",
    "LATENCY_K_MAX", "TorchHashgraph", "consensus_sort", "fold",
]
