"""Redis-backed distributed index (optional, for multi-indexer HA).

Parity with reference ``pkg/kvcache/kvblock/redis.go``: one Redis hash per
block key (name = ``str(key)``), field = ``pod@tier``, value = RFC-3339
timestamp of last update; lookup is a single pipelined round-trip of
``HKEYS`` per key. Unlike the in-memory backend, a *missing* key also breaks
the prefix chain here (``redis.go:133-136``) because Redis cannot
distinguish missing from empty hashes.

The client is injectable (any object with ``ping()``, ``pipeline()``,
``hset``/``hkeys``/``hdel``) so tests run against an in-process fake and
deployments may use ``redis.Redis`` when the package is installed.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

from ...utils import get_logger
from .index import Index, RedisIndexConfig
from .keys import DeviceTier, Key, PodEntry

log = get_logger("kvcache.kvblock.redis")


def _normalize_address(address: str) -> str:
    if not address.startswith(("redis://", "rediss://", "unix://")):
        return "redis://" + address
    return address


class RedisIndex(Index):
    def __init__(self, config: Optional[RedisIndexConfig] = None):
        self.config = config or RedisIndexConfig()
        if self.config.client is not None:
            self._client = self.config.client
        else:
            try:
                import redis  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "RedisIndex requires the `redis` package or an injected "
                    "client (RedisIndexConfig.client)"
                ) from e
            self._client = redis.Redis.from_url(_normalize_address(self.config.address))
        self._client.ping()

    def lookup(
        self, keys: Sequence[Key], pod_filter: Optional[set[str]] = None
    ) -> dict[Key, list[str]]:
        if not keys:
            return {}

        pipe = self._client.pipeline()
        for key in keys:
            pipe.hkeys(str(key))
        results = pipe.execute()

        pods_per_key: dict[Key, list[str]] = {}
        for key, fields in zip(keys, results):
            filtered: list[str] = []
            for field in fields:
                if isinstance(field, bytes):
                    field = field.decode("utf-8")
                pod_id = field.split("@", 1)[0]
                if not pod_filter or pod_id in pod_filter:
                    filtered.append(pod_id)
            if not filtered:
                log.trace("no pods found for key, cutting search", key=str(key))
                return pods_per_key
            pods_per_key[key] = filtered
        return pods_per_key

    def add(self, keys: Sequence[Key], entries: Sequence[PodEntry]) -> None:
        if not keys or not entries:
            return
        now = datetime.datetime.now(datetime.timezone.utc).isoformat()
        pipe = self._client.pipeline()
        for key in keys:
            for entry in entries:
                pipe.hset(str(key), str(entry), now)
        pipe.execute()

    def evict(self, key: Key, entries: Sequence[PodEntry]) -> None:
        pipe = self._client.pipeline()
        for entry in entries:
            pipe.hdel(str(key), str(entry))
        pipe.execute()

    def evict_pod(self, pod_identifier: str) -> int:
        """Dead-pod sweep: remove the pod's field (every tier) from every
        block hash. Redis deletes a hash when its last field goes, so keys
        whose pod set empties disappear — matching the in-memory backends.

        One SCAN + one pipelined HDEL wave; the keyspace is the block
        index itself (no other key families share the DB per the
        deployment contract), so a full scan is the sweep's working set by
        definition.
        """
        if hasattr(self._client, "scan_iter"):
            keys = list(self._client.scan_iter())
        else:  # minimal clients/fakes without SCAN support
            keys = list(self._client.keys())
        if not keys:
            return 0
        fields = [f"{pod_identifier}@{tier}" for tier in DeviceTier]
        pipe = self._client.pipeline()
        for key in keys:
            pipe.hdel(key, *fields)
        removed = sum(int(n) for n in pipe.execute())
        if removed:
            log.debug("swept pod from index", pod=pod_identifier, entries=removed)
        return removed
