"""A minimal LRU cache.

Replaces the reference's ``cachetools.LRUCache`` dependency
(reference hyperdb.py:60) with a dependency-free
OrderedDict-backed implementation exposing the same surface the DB uses:
``maxsize``, ``__contains__``, ``__getitem__``, ``__setitem__``, ``clear``,
``__len__``.
"""

from __future__ import annotations

from collections import OrderedDict


class LRUCache:
    def __init__(self, maxsize: int = 256):
        if maxsize < 0:
            raise ValueError("maxsize must be >= 0")
        self.maxsize = maxsize
        self._data: OrderedDict = OrderedDict()

    def __contains__(self, key) -> bool:
        return key in self._data

    def __getitem__(self, key):
        value = self._data[key]
        self._data.move_to_end(key)
        return value

    def get(self, key, default=None):
        if key in self._data:
            return self[key]
        return default

    def __setitem__(self, key, value) -> None:
        if self.maxsize == 0:
            return
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self):
        return iter(self._data)

    def clear(self) -> None:
        self._data.clear()

    def items(self):
        return self._data.items()
