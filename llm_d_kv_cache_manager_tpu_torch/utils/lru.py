"""Thread-safe LRU containers used across the index and token stores."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Generic, Hashable, Iterator, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class LRUCache(Generic[K, V]):
    """Bounded LRU map. Get/contains refresh recency; eviction drops the
    least-recently-used entry. All operations hold an internal lock."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"LRU capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.RLock()
        self._data: OrderedDict[K, V] = OrderedDict()  # guarded_by: _lock

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            if key not in self._data:
                return None
            self._data.move_to_end(key)
            return self._data[key]

    def put(self, key: K, value: V) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def get_or_put(self, key: K, value: V) -> tuple[V, bool]:
        """Atomic double-checked insert: returns (current_value, existed)."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return self._data[key], True
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
            return value, False

    def remove(self, key: K) -> bool:
        with self._lock:
            return self._data.pop(key, None) is not None

    def __contains__(self, key: K) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def keys(self) -> list[K]:
        """Snapshot of keys, least-recently-used first."""
        with self._lock:
            return list(self._data.keys())

    def items(self) -> list[tuple[K, V]]:
        with self._lock:
            return list(self._data.items())

    def __iter__(self) -> Iterator[K]:
        return iter(self.keys())
