"""The consensus engine (``engine.TorchHashgraph``), the straight-line
oracle it is held to (``oracle.OracleHashgraph``), the fork-aware
(byzantine-mode) pair (``byzantine.ForkOracle``, the definition-first
oracle, and ``fork_engine.ForkHashgraph`` over ``ops/forks.py``), the
wide-N live engine (``wide_engine.WideHashgraph`` over
``ops/stream.py``), the final ordering (``ordering``) and the rolling commit digest
(``digest``)."""

from .byzantine import ByzantineInsertError, ForkOracle
from .digest import CommitDigest, fold
from .engine import LATENCY_K_MAX, TorchHashgraph
from .fork_engine import ForkHashgraph
from .ordering import consensus_sort
from .wide_engine import WideHashgraph
# last: the oracle's store/inmem.py loads store/, whose checkpoint module
# imports the engines above
from .oracle import OracleHashgraph

__all__ = [
    "ByzantineInsertError", "CommitDigest", "ForkHashgraph", "ForkOracle",
    "LATENCY_K_MAX", "OracleHashgraph", "TorchHashgraph", "WideHashgraph",
    "consensus_sort", "fold",
]
