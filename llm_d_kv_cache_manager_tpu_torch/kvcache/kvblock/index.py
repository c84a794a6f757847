"""KV-block index: interface + factory.

Parity with reference ``pkg/kvcache/kvblock/index.go``: a pluggable store
that aggregates the global KV-block locality index — which TPU server
replicas hold which blocks, on which memory tier — and answers
longest-prefix lookups for the scorer.

Semantics (mirroring ``in_memory.go:97-141``):

- ``lookup`` walks the ordered key chain. A key that is *present but has no
  pods* terminates the walk (the prefix chain is broken there); a key that is
  simply absent is skipped but the walk continues.
- An empty ``pod_filter`` means "all pods".
- Operations are thread-safe.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .keys import Key, PodEntry


class Index(ABC):
    """Backend that tracks KV-block → pod-locality mappings."""

    @abstractmethod
    def lookup(
        self, keys: Sequence[Key], pod_filter: Optional[set[str]] = None
    ) -> dict[Key, list[str]]:
        """Return pod identifiers per key, filtered to ``pod_filter`` when
        non-empty. Stops scanning at the first present-but-empty key."""

    @abstractmethod
    def add(self, keys: Sequence[Key], entries: Sequence[PodEntry]) -> None:
        """Record that each pod entry holds each key's block."""

    @abstractmethod
    def evict(self, key: Key, entries: Sequence[PodEntry]) -> None:
        """Remove pod entries for a key; drop the key once no pods remain."""

    @abstractmethod
    def evict_pod(self, pod_identifier: str) -> int:
        """Fleet self-healing sweep: remove EVERY entry belonging to
        ``pod_identifier`` (all keys, all tiers, all models), dropping keys
        whose pod set empties. Used by the dead-pod sweeper after TTL
        expiry and by ``IndexSnapshot`` replace-all-for-pod reconciliation.
        Returns the number of entries removed."""

    def size_info(self) -> Optional[dict]:
        """Occupancy snapshot for the ``kvcache_index_blocks`` /
        ``kvcache_index_pods`` gauges: ``{"blocks": <tracked block keys>,
        "pods": <distinct pods with >= 1 entry>}``. May walk the index —
        scrape-driven callers only (``/stats``, ``/metrics``). None when
        the backend cannot answer cheaply (e.g. a remote Redis)."""
        return None

    def pod_names(self) -> Optional[Sequence[str]]:
        """Distinct pod identifiers the backend can enumerate cheaply (for
        the native backend: pods ever interned, a documented superset).
        Lets ``ShardedIndex`` union pods across shards so the aggregate
        ``size_info`` stays truthful. None when enumeration would require
        a remote walk (e.g. Redis) — callers fall back to counts."""
        return None


@dataclass
class InMemoryIndexConfig:
    # Maximum number of block keys tracked (reference default 1e8,
    # in_memory.go:33).
    size: int = 100_000_000
    # Maximum pod entries per key (reference default 10, in_memory.go:34).
    pod_cache_size: int = 10


@dataclass
class CostAwareMemoryIndexConfig:
    # Total budget for estimated entry byte-cost (reference default "2GiB",
    # cost_aware_memory.go:45-49).
    max_cost_bytes: int = 2 * 1024**3


@dataclass
class NativeMemoryIndexConfig:
    """C++ two-level LRU (same semantics as InMemoryIndexConfig); requires
    the native library (``python -m llm_d_kv_cache_manager_tpu_torch.native.build``)."""

    size: int = 100_000_000
    pod_cache_size: int = 10


@dataclass
class RedisIndexConfig:
    # URL form: redis://[user:pass@]host:port/db
    address: str = "redis://localhost:6379"
    # Injected client factory for testing / alternative clients; when None the
    # `redis` package is imported lazily.
    client: object | None = None


@dataclass
class IndexConfig:
    """Picks the first configured backend: native > in-memory > cost-aware >
    redis (extending reference ``index.go:57-97`` with the C++ backend)."""

    native_memory: Optional[NativeMemoryIndexConfig] = None
    in_memory: Optional[InMemoryIndexConfig] = field(default_factory=InMemoryIndexConfig)
    cost_aware: Optional[CostAwareMemoryIndexConfig] = None
    redis: Optional[RedisIndexConfig] = None
    enable_metrics: bool = False
    # Seconds between metrics-beat log lines; 0 disables (requires
    # enable_metrics).
    metrics_logging_interval: float = 0.0


def create_index(config: Optional[IndexConfig] = None) -> Index:
    cfg = config or IndexConfig()

    idx: Index
    if cfg.native_memory is not None:
        from .native_memory import NativeMemoryIndex

        idx = NativeMemoryIndex(cfg.native_memory)
    elif cfg.in_memory is not None:
        from .in_memory import InMemoryIndex

        idx = InMemoryIndex(cfg.in_memory)
    elif cfg.cost_aware is not None:
        from .cost_aware import CostAwareMemoryIndex

        idx = CostAwareMemoryIndex(cfg.cost_aware)
    elif cfg.redis is not None:
        from .redis_index import RedisIndex

        idx = RedisIndex(cfg.redis)
    else:
        raise ValueError("no valid index configuration provided")

    if cfg.enable_metrics:
        from ..metrics import collector
        from .instrumented import InstrumentedIndex

        collector.register()
        idx = InstrumentedIndex(idx)
        if cfg.metrics_logging_interval > 0:
            collector.start_metrics_logging(cfg.metrics_logging_interval)

    return idx
