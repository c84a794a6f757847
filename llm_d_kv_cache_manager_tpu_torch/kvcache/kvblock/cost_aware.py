"""Cost-aware in-memory index: bounded by estimated byte footprint.

Parity with reference ``pkg/kvcache/kvblock/cost_aware_memory.go``: instead
of bounding by entry *count*, each key's entry is charged an estimated byte
cost (strings + per-entry overhead, mirroring ``CalculateByteSize``
``cost_aware_memory.go:111-143``) and the store evicts least-recently-used
keys until the total cost fits the configured budget (default 2 GiB).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence

from ...utils import get_logger
from .index import CostAwareMemoryIndexConfig, Index
from .keys import Key, PodEntry

log = get_logger("kvcache.kvblock.cost_aware")

# Fixed bookkeeping overhead charged per key entry and per pod entry, on top
# of string payloads. Deliberately generous: the goal is an upper-bound-ish
# estimate so the budget is honored, not exact accounting.
_KEY_OVERHEAD = 96
_POD_OVERHEAD = 64


def estimate_entry_cost(key: Key, pods: set[PodEntry]) -> int:
    cost = _KEY_OVERHEAD + len(key.model_name) + 8  # model string + uint64 hash
    for p in pods:
        cost += _POD_OVERHEAD + len(p.pod_identifier) + len(str(p.device_tier))
    return cost


class CostAwareMemoryIndex(Index):
    def __init__(self, config: Optional[CostAwareMemoryIndexConfig] = None):
        self.config = config or CostAwareMemoryIndexConfig()
        if self.config.max_cost_bytes < 1:
            raise ValueError("max_cost_bytes must be >= 1")
        self._lock = threading.RLock()
        self._data: OrderedDict[Key, set[PodEntry]] = OrderedDict()  # guarded_by: _lock
        self._costs: dict[Key, int] = {}  # guarded_by: _lock
        self._total_cost = 0  # guarded_by: _lock

    @property
    def total_cost(self) -> int:
        with self._lock:
            return self._total_cost

    def _recost(self, key: Key) -> None:  # kvlint: holds=_lock
        """Recompute a key's charge and evict LRU keys while over budget."""
        new_cost = estimate_entry_cost(key, self._data[key])
        self._total_cost += new_cost - self._costs.get(key, 0)
        self._costs[key] = new_cost
        while self._total_cost > self.config.max_cost_bytes and self._data:
            evict_key, _ = self._data.popitem(last=False)
            self._total_cost -= self._costs.pop(evict_key, 0)
            log.trace("cost eviction", key=str(evict_key))

    def lookup(
        self, keys: Sequence[Key], pod_filter: Optional[set[str]] = None
    ) -> dict[Key, list[str]]:
        if not keys:
            raise ValueError("no keys provided for lookup")
        pods_per_key: dict[Key, list[str]] = {}
        with self._lock:
            for key in keys:
                pods = self._data.get(key)
                if pods is None:
                    continue
                self._data.move_to_end(key)
                if not pods:
                    return pods_per_key
                if not pod_filter:
                    pods_per_key[key] = [e.pod_identifier for e in pods]
                else:
                    filtered = [
                        e.pod_identifier for e in pods if e.pod_identifier in pod_filter
                    ]
                    if filtered:
                        pods_per_key[key] = filtered
        return pods_per_key

    def add(self, keys: Sequence[Key], entries: Sequence[PodEntry]) -> None:
        if not keys or not entries:
            raise ValueError("no keys or entries provided for adding to index")
        with self._lock:
            for key in keys:
                pods = self._data.get(key)
                if pods is None:
                    pods = set()
                    self._data[key] = pods
                else:
                    self._data.move_to_end(key)
                pods.update(entries)
                self._recost(key)

    def evict(self, key: Key, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        with self._lock:
            pods = self._data.get(key)
            if pods is None:
                return
            for entry in entries:
                pods.discard(entry)
            if not pods:
                del self._data[key]
                self._total_cost -= self._costs.pop(key, 0)
            else:
                self._recost(key)

    def size_info(self) -> dict:
        with self._lock:
            pods = {e.pod_identifier for ps in self._data.values() for e in ps}
            return {"blocks": len(self._data), "pods": len(pods)}

    def pod_names(self) -> list[str]:
        with self._lock:
            return sorted(
                {e.pod_identifier for ps in self._data.values() for e in ps}
            )

    def evict_pod(self, pod_identifier: str) -> int:
        removed = 0
        with self._lock:
            for key in list(self._data):
                pods = self._data[key]
                stale = [e for e in pods if e.pod_identifier == pod_identifier]
                if not stale:
                    continue
                pods.difference_update(stale)
                removed += len(stale)
                if not pods:
                    del self._data[key]
                    self._total_cost -= self._costs.pop(key, 0)
                else:
                    self._recost(key)
        if removed:
            log.debug("swept pod from index", pod=pod_identifier, entries=removed)
        return removed
