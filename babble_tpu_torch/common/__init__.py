"""Host-side containers and error types (reference: common/): the port's
copy of the JAX package's ``common``.

- ``OffsetList``: append-only list with an evictable prefix (the engine's
  rolling windows);
- ``LRU`` and ``RollingList``: bounded caches;
- ``aserver``: the asyncio TCP server helper of the transports;
- ``KeyNotFoundError`` / ``TooLateError``: the cache misses a sync turns
  into a fast-forward.
"""

from .errors import KeyNotFoundError, TooLateError
from .lru import LRU
from .offset_list import OffsetList
from .rolling_list import RollingList

__all__ = [
    "LRU", "OffsetList", "RollingList", "KeyNotFoundError", "TooLateError",
]
