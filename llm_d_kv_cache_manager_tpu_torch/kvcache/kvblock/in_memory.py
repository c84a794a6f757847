"""Default in-memory index: two-level LRU.

Parity with reference ``pkg/kvcache/kvblock/in_memory.go``: an LRU of
key → pod-LRU, bounded by key count and pods-per-key. Lookup terminates at a
present-but-empty key (broken prefix chain, ``in_memory.go:110-114``); add
uses an atomic get-or-insert so concurrent adders share one pod cache
(``:155-183``); evict drops the key once its pod set empties (``:216-235``).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from ...utils import get_logger
from ...utils.lru import LRUCache
from .index import Index, InMemoryIndexConfig
from .keys import Key, PodEntry

log = get_logger("kvcache.kvblock.in_memory")


class _PodCache:
    """Per-key LRU of pod entries."""

    __slots__ = ("cache", "mu")

    def __init__(self, capacity: int):
        self.cache: LRUCache[PodEntry, None] = LRUCache(capacity)
        self.mu = threading.Lock()


class InMemoryIndex(Index):
    def __init__(self, config: Optional[InMemoryIndexConfig] = None):
        self.config = config or InMemoryIndexConfig()
        self._data: LRUCache[Key, _PodCache] = LRUCache(self.config.size)

    def lookup(
        self, keys: Sequence[Key], pod_filter: Optional[set[str]] = None
    ) -> dict[Key, list[str]]:
        if not keys:
            raise ValueError("no keys provided for lookup")

        pods_per_key: dict[Key, list[str]] = {}
        for key in keys:
            pod_cache = self._data.get(key)
            if pod_cache is None:
                log.trace("key not found in index", key=str(key))
                continue
            entries = pod_cache.cache.keys()
            if not entries:
                # prefix chain breaks here: stop scanning further keys
                log.trace("no pods found for key, cutting search", key=str(key))
                return pods_per_key
            if not pod_filter:
                pods_per_key[key] = [e.pod_identifier for e in entries]
            else:
                filtered = [
                    e.pod_identifier for e in entries if e.pod_identifier in pod_filter
                ]
                # Key recorded only when pods survive the filter; a
                # filtered-to-empty key does NOT break the scan (only an
                # inherently empty pod cache does, in_memory.go:111-131).
                if filtered:
                    pods_per_key[key] = filtered
        return pods_per_key

    def add(self, keys: Sequence[Key], entries: Sequence[PodEntry]) -> None:
        if not keys or not entries:
            raise ValueError("no keys or entries provided for adding to index")

        for key in keys:
            # fast path avoids allocating a throwaway _PodCache per hot-key add
            pod_cache = self._data.get(key)
            if pod_cache is None:
                pod_cache, _existed = self._data.get_or_put(
                    key, _PodCache(self.config.pod_cache_size)
                )
            with pod_cache.mu:
                for entry in entries:
                    pod_cache.cache.put(entry, None)
            log.trace("added pods to key", key=str(key), pods=[str(e) for e in entries])

    def evict(self, key: Key, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")

        pod_cache = self._data.get(key)
        if pod_cache is None:
            log.trace("key not found in index, nothing to evict", key=str(key))
            return

        with pod_cache.mu:
            for entry in entries:
                pod_cache.cache.remove(entry)
            is_empty = len(pod_cache.cache) == 0

        if is_empty:
            # Re-check under the pod lock; worst case an empty cache lingers
            # until LRU-evicted (same tolerance as the reference).
            current = self._data.get(key)
            if current is not None:
                with current.mu:
                    if len(current.cache) == 0:
                        self._data.remove(key)
                        log.trace("evicted key from index as no pods remain", key=str(key))

    def size_info(self) -> dict:
        pods: set[str] = set()
        blocks = 0
        # items() snapshots without promoting (the evict_pod rule): a
        # metrics scrape must not perturb key recency.
        for _key, pod_cache in self._data.items():
            blocks += 1
            with pod_cache.mu:
                pods.update(e.pod_identifier for e in pod_cache.cache.keys())
        return {"blocks": blocks, "pods": len(pods)}

    def pod_names(self) -> list[str]:
        pods: set[str] = set()
        for _key, pod_cache in self._data.items():
            with pod_cache.mu:
                pods.update(e.pod_identifier for e in pod_cache.cache.keys())
        return sorted(pods)

    def evict_pod(self, pod_identifier: str) -> int:
        removed = 0
        # items() snapshots without promoting, so a sweep does not disturb
        # key recency; keys added concurrently simply miss this pass (the
        # pod is alive again, its entries belong).
        for key, pod_cache in self._data.items():
            with pod_cache.mu:
                stale = [
                    e
                    for e in pod_cache.cache.keys()
                    if e.pod_identifier == pod_identifier
                ]
                for e in stale:
                    pod_cache.cache.remove(e)
                removed += len(stale)
                is_empty = len(pod_cache.cache) == 0
            if is_empty:
                current = self._data.get(key)
                if current is not None:
                    with current.mu:
                        if len(current.cache) == 0:
                            self._data.remove(key)
        if removed:
            log.debug("swept pod from index", pod=pod_identifier, entries=removed)
        return removed
