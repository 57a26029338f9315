"""Append-only list with an evictable prefix: the port's copy of the JAX
package's ``common/offset_list.py``.

``OffsetList`` is an append-only list with an evictable prefix:
``lst[i]`` always refers to the i-th item ever appended, items below
``start`` have been evicted and raise ``TooLateError`` (the reference's
rolling-cache semantics, caches.go:45-76, with eviction driven by
consensus progress).  ``len()`` is the total ever appended; iteration
yields only the live window.
"""

from __future__ import annotations

from typing import Any, Iterator, List

from .errors import KeyNotFoundError, TooLateError


class OffsetList:
    __slots__ = ("_items", "start")

    def __init__(self, items=(), start: int = 0):
        self._items: List[Any] = list(items)
        self.start = start

    def __len__(self) -> int:
        return self.start + len(self._items)

    def __bool__(self) -> bool:
        return len(self) > 0

    @property
    def window(self) -> List[Any]:
        """The live items (absolute indices [start, len))."""
        return self._items

    def __iter__(self) -> Iterator[Any]:
        return iter(self._items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            if i.step is not None and i.step != 1:
                raise ValueError("OffsetList slices must be contiguous")
            lo = i.start if i.start is not None else self.start
            if lo < 0:
                lo += len(self)
            hi = i.stop if i.stop is not None else len(self)
            if hi < 0:
                hi += len(self)
            if lo >= len(self) or hi <= lo:
                return []
            if lo < self.start:
                raise TooLateError(lo)
            return self._items[lo - self.start: hi - self.start]
        if i < 0:
            i += len(self)
        if i < self.start:
            raise TooLateError(i)
        if i >= len(self):
            raise KeyNotFoundError(i)
        return self._items[i - self.start]

    def __setitem__(self, i: int, v) -> None:
        if i < 0:
            i += len(self)
        if i < self.start:
            raise TooLateError(i)
        if i >= len(self):
            raise KeyNotFoundError(i)
        self._items[i - self.start] = v

    def append(self, v) -> None:
        self._items.append(v)

    def evict_to(self, new_start: int) -> List[Any]:
        """Drop items below absolute index ``new_start``; returns them."""
        if new_start <= self.start:
            return []
        if new_start > len(self):
            raise KeyNotFoundError(new_start)
        k = new_start - self.start
        evicted, self._items = self._items[:k], self._items[k:]
        self.start = new_start
        return evicted
