"""Bounded LRU cache with eviction callback (reference: common/lru.go).

Python's OrderedDict gives us the recency list the Go version hand-rolls
with container/list.  Not thread-safe, same as the reference
(common/lru.go:25); guard externally if shared.
"""

from collections import OrderedDict
from typing import Any, Callable, Optional


class LRU:
    def __init__(self, size: int, on_evict: Optional[Callable[[Any, Any], None]] = None):
        if size <= 0:
            raise ValueError("LRU size must be positive")
        self.size = size
        self.on_evict = on_evict
        self._items: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key) -> bool:
        return key in self._items

    def get(self, key):
        """Return (value, True) and mark recently-used, or (None, False)."""
        try:
            self._items.move_to_end(key)
        except KeyError:
            return None, False
        return self._items[key], True

    def peek(self, key):
        """Like get() but without updating recency."""
        if key in self._items:
            return self._items[key], True
        return None, False

    def add(self, key, value) -> bool:
        """Insert/refresh a key.  Returns True if an eviction occurred."""
        if key in self._items:
            self._items.move_to_end(key)
            self._items[key] = value
            return False
        self._items[key] = value
        if len(self._items) > self.size:
            self._evict_oldest()
            return True
        return False

    def remove(self, key) -> bool:
        if key in self._items:
            value = self._items.pop(key)
            if self.on_evict is not None:
                self.on_evict(key, value)
            return True
        return False

    def keys(self):
        """Keys oldest-to-newest (reference common/lru.go Keys())."""
        return list(self._items.keys())

    def purge(self):
        while self._items:
            self._evict_oldest()

    def _evict_oldest(self):
        key, value = self._items.popitem(last=False)
        if self.on_evict is not None:
            self.on_evict(key, value)
