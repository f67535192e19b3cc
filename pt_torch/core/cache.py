"""Fixed-capacity recency cache + FNV-1a hashing.

Port of `pt.core.cache` (≙ the reference's `LRUCache`/`FNVHash`,
Core/Cache.h:10-131). The `Renderer` keys its static acceleration
structures with it. Eviction returns the evicted entry so the caller can
release it (reference: Cache.h:88-104 returns the evicted pipeline for
destruction).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Generic, Hashable, Optional, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def fnv1a(data: bytes) -> int:
    """64-bit FNV-1a over raw bytes (≙ FNVHash, Core/Cache.h:10-36)."""
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


class LRUCache(Generic[K, V]):
    """Capacity-bounded cache; `get` refreshes recency, `put` evicts the
    least recently used entry.

    `put` returns (evicted_key, evicted_value) when the capacity is
    exceeded, else None: the reference's eviction-return contract.
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._data: "OrderedDict[K, V]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: K) -> bool:
        return key in self._data

    def get(self, key: K) -> Optional[V]:
        if key not in self._data:
            return None
        self._data.move_to_end(key)
        return self._data[key]

    def put(self, key: K, value: V) -> Optional[Tuple[K, V]]:
        if key in self._data:
            self._data.move_to_end(key)
            self._data[key] = value
            return None
        self._data[key] = value
        if len(self._data) > self.capacity:
            return self._data.popitem(last=False)
        return None

    def clear(self) -> None:
        self._data.clear()
