"""Metrics decorator around any Index backend.

Parity with reference ``pkg/kvcache/kvblock/instrumented_index.go``: wraps an
``Index`` and emits admissions / evictions / lookup-request / lookup-latency
metrics around each call. Also increments the per-key hit counter the
reference defined but never wired (SURVEY §5 gap).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from ..metrics import collector
from .index import Index
from .keys import Key, PodEntry


class InstrumentedIndex(Index):
    def __init__(self, inner: Index):
        self._inner = inner

    @property
    def inner(self) -> Index:
        return self._inner

    def size_info(self):
        # Explicit delegation: the base class has a concrete None-returning
        # default, so __getattr__ never fires for this name.
        return self._inner.size_info()

    def pod_names(self):
        # Same explicit-delegation rule as size_info.
        return self._inner.pod_names()

    def lookup(
        self, keys: Sequence[Key], pod_filter: Optional[set[str]] = None
    ) -> dict[Key, list[str]]:
        collector.lookup_requests.inc()
        collector.bump("lookup_requests")
        start = time.perf_counter()
        try:
            result = self._inner.lookup(keys, pod_filter)
        finally:
            collector.lookup_latency.observe(time.perf_counter() - start)
        hits = sum(1 for pods in result.values() if pods)
        if hits:
            collector.lookup_hits.inc(hits)
            collector.bump("lookup_hits", hits)
        return result

    def add(self, keys: Sequence[Key], entries: Sequence[PodEntry]) -> None:
        self._inner.add(keys, entries)
        n = len(keys) * len(entries)
        collector.admissions.inc(n)
        collector.bump("admissions", n)

    def evict(self, key: Key, entries: Sequence[PodEntry]) -> None:
        self._inner.evict(key, entries)
        collector.evictions.inc(len(entries))
        collector.bump("evictions", len(entries))

    def evict_pod(self, pod_identifier: str) -> int:
        removed = self._inner.evict_pod(pod_identifier)
        if removed:
            collector.evictions.inc(removed)
            collector.bump("evictions", removed)
        return removed

    def __getattr__(self, name: str):
        # Fused scoring entry points (NativeMemoryIndex) pass through the
        # decorator with the same lookup metrics; __getattr__ only fires
        # when the attribute is absent here, so plain backends stay plain
        # and the indexer's getattr discovery keeps working. The *_with_hits
        # variants report the same keys-with-surviving-pods hit count the
        # two-step path records, so NATIVE_INDEX does not shift dashboards.
        if name in ("score_longest_prefix", "score_hashes"):
            inner_fn = getattr(self._inner, name + "_with_hits")

            def wrapped(*args, **kwargs):
                start = time.perf_counter()
                out = inner_fn(*args, **kwargs)
                elapsed = time.perf_counter() - start
                if out is None:  # mixed-model fallback: two-step path counts
                    return None
                collector.lookup_requests.inc()
                collector.bump("lookup_requests")
                collector.lookup_latency.observe(elapsed)
                scores, hits = out
                if hits:
                    collector.lookup_hits.inc(hits)
                    collector.bump("lookup_hits", hits)
                return scores

            return wrapped
        raise AttributeError(name)
