"""Bounded sliding window over an append-only sequence (reference: common/rolling_list.go).

Keeps the last ~2*size items plus the total count ever added.  Indexing an
item that rolled out raises TooLateError; indexing past the end raises
KeyNotFoundError — identical semantics to the reference so the gossip diff
path can distinguish "evicted" from "not yet created".
"""

from typing import Any, List, Tuple

from .errors import KeyNotFoundError, TooLateError


class RollingList:
    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("RollingList size must be positive")
        self.size = size
        self._tot = 0
        self._items: List[Any] = []

    def get(self) -> Tuple[List[Any], int]:
        """Return (current window, total items ever added)."""
        return self._items, self._tot

    @property
    def total(self) -> int:
        return self._tot

    def get_item(self, index: int) -> Any:
        oldest_cached = self._tot - len(self._items)
        if index < oldest_cached:
            raise TooLateError(index)
        findex = index - oldest_cached
        if findex >= len(self._items):
            raise KeyNotFoundError(index)
        return self._items[findex]

    def add(self, item: Any) -> None:
        if len(self._items) >= 2 * self.size:
            # Roll: drop the oldest `size` items, keep the newest ~size
            # (reference common/rolling_list.go:55-67).
            self._items = self._items[self.size:]
        self._items.append(item)
        self._tot += 1
