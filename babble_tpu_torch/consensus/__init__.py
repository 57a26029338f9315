"""The consensus engine (``engine.TorchHashgraph``), its final ordering
(``ordering``) and the rolling commit digest (``digest``)."""

from .digest import CommitDigest, fold
from .engine import LATENCY_K_MAX, TorchHashgraph
from .ordering import consensus_sort

__all__ = [
    "CommitDigest", "LATENCY_K_MAX", "TorchHashgraph", "consensus_sort",
    "fold",
]
