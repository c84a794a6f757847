"""Native (C++) in-memory index backend.

Same contract and two-level-LRU semantics as ``InMemoryIndex`` (the parity
port of the reference's ``in_memory.go``), with the hot structure in C++
behind a ctypes boundary: integer-only calls on the lookup path (model and
pod names are interned to u32 ids here, tiers to u8), one native call per
``lookup``/``add`` batch instead of per-key Python dict/lock traffic.

Read paths take NO Python lock: the intern tables are copy-on-write — every
mutation (interning a new pod/model under ``_mu``, a rare event at fleet
scale) publishes a fresh immutable snapshot in a single attribute store
(atomic under the GIL), and readers resolve names through whatever snapshot
they grabbed. A reader racing an intern either sees the name (and resolves
it) or doesn't (and treats it as never-seen — exactly what the pre-publish
state was). ``lookup_hashes_ro`` additionally uses the C++ shared-lock
read-side walk (no LRU promotion), so sharded score fan-outs proceed
concurrently with event applies end to end.

Passes the same backend conformance suite as every other Index
(tests/test_index_backends.py), and is selected via
``IndexConfig.native_memory`` when the shared library is built.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from ...native import lruindex as _native
from ...utils import get_logger
from .index import Index, NativeMemoryIndexConfig
from .keys import DeviceTier, Key, PodEntry

log = get_logger("kvcache.kvblock.native_memory")

_TIERS = list(DeviceTier)
_TIER_TO_ID = {t: i for i, t in enumerate(_TIERS)}


def native_available() -> bool:
    return _native.available()


class _Interns:
    """One immutable published generation of the intern tables. Instances
    are never mutated after construction — ``InternStore`` replaces the
    whole snapshot under its write lock, readers dereference lock-free."""

    __slots__ = ("model_ids", "pod_ids", "pod_names")

    def __init__(self, model_ids: dict, pod_ids: dict, pod_names: tuple):
        self.model_ids = model_ids
        self.pod_ids = pod_ids
        self.pod_names = pod_names


class InternStore:
    """Pod/model name ↔ u32 id tables. One per index by default; a shard
    GROUP (``NativeMemoryIndex.shard_group``) shares one so ids are
    comparable across every shard's C structure — the cross-shard fused
    scorer intersects pod ids from different shards in one C call, which
    is only meaningful under a common interning. Write side under ``_mu``
    (interning is once per new name ever seen); readers use the
    atomically published immutable ``snap``."""

    def __init__(self):
        self._mu = threading.Lock()
        self._model_ids: dict[str, int] = {}  # guarded_by: _mu
        self._pod_ids: dict[str, int] = {}  # guarded_by: _mu
        self._pod_names: list[str] = []  # guarded_by: _mu
        #: immutable snapshot, atomically re-published on intern (GIL store)
        self.snap = _Interns({}, {}, ())

    def model_id(self, name: str, *, create: bool) -> Optional[int]:
        mid = self.snap.model_ids.get(name)
        if mid is not None or not create:
            return mid
        with self._mu:
            mid = self._model_ids.get(name)
            if mid is None:
                mid = len(self._model_ids)
                self._model_ids[name] = mid
                self._publish()
            return mid

    def pod_id(self, name: str, *, create: bool) -> Optional[int]:
        pid = self.snap.pod_ids.get(name)
        if pid is not None or not create:
            return pid
        with self._mu:
            pid = self._pod_ids.get(name)
            if pid is None:
                pid = len(self._pod_names)
                self._pod_ids[name] = pid
                self._pod_names.append(name)
                self._publish()
            return pid

    def _publish(self) -> None:  # kvlint: holds=_mu
        self.snap = _Interns(
            dict(self._model_ids), dict(self._pod_ids), tuple(self._pod_names)
        )


class NativeMemoryIndex(Index):
    #: filter id that matches no interned pod: filters everything out while
    #: still walking (and LRU-promoting) the chain like the Python backend.
    _NO_MATCH_FILTER = 0xFFFFFFFF

    def __init__(
        self,
        config: Optional[NativeMemoryIndexConfig] = None,
        *,
        interns: Optional[InternStore] = None,
    ):
        self.config = config or NativeMemoryIndexConfig()
        self._idx = _native.NativeLru(self.config.size, self.config.pod_cache_size)
        #: per-index by default; a shard group passes one shared store
        self._interns = interns if interns is not None else InternStore()

    @classmethod
    def shard_group(
        cls, n_shards: int, config: Optional[NativeMemoryIndexConfig] = None
    ) -> list["NativeMemoryIndex"]:
        """N sub-indexes sharing ONE intern table — the configuration the
        cross-shard fused C scorer requires (``ShardedIndex`` detects it
        and serves score fan-outs in a single native call)."""
        store = InternStore()
        return [cls(config, interns=store) for _ in range(n_shards)]

    # -- interning ----------------------------------------------------------
    @property
    def _snap(self) -> _Interns:
        return self._interns.snap

    def _model_id(self, name: str, *, create: bool) -> Optional[int]:
        return self._interns.model_id(name, create=create)

    def _pod_id(self, name: str, *, create: bool) -> Optional[int]:
        return self._interns.pod_id(name, create=create)

    def _filter_ids(self, pod_filter: Optional[set[str]]) -> list[int]:
        if not pod_filter:
            return []
        pod_ids = self._snap.pod_ids
        ids = [pid for pid in (pod_ids.get(n) for n in pod_filter) if pid is not None]
        # Every filter pod unknown: nothing can match, but the chain must
        # still be walked (and keys promoted) exactly as the Python backend
        # does — a no-match sentinel keeps filtering active.
        return ids or [self._NO_MATCH_FILTER]

    # -- Index contract -----------------------------------------------------
    def lookup(
        self, keys: Sequence[Key], pod_filter: Optional[set[str]] = None
    ) -> dict[Key, list[str]]:
        if not keys:
            raise ValueError("no keys provided for lookup")
        filter_ids = self._filter_ids(pod_filter)
        out: dict[Key, list[str]] = {}
        # One native call per consecutive same-model run (the hot path is
        # always single-model; this keeps mixed-model batches correct).
        i, n = 0, len(keys)
        while i < n:
            j = i
            model = keys[i].model_name
            while j < n and keys[j].model_name == model:
                j += 1
            mid = self._model_id(model, create=False)
            if mid is None:
                i = j  # unknown model: every key missing — chain continues
                continue
            processed, per_key = self._idx.lookup(
                mid, [k.chunk_hash for k in keys[i:j]], filter_ids
            )
            names = self._snap.pod_names
            for key, pods in zip(keys[i:j], per_key):
                if pods:
                    out[key] = [names[pid] for pid, _tier in pods]
            if processed < j - i:  # present-but-empty key: stop the scan
                return out
            i = j
        return out

    def lookup_hashes_ro(
        self,
        model_name: str,
        hashes: Sequence[int],
        pod_filter: Optional[set[str]] = None,
    ) -> Optional[tuple[int, list[list[str]]]]:
        """Read-side lookup from raw chain hashes: C++ shared lock, no LRU
        promotion, no Python lock — the sharded score fan-out's per-shard
        read. Returns ``(processed, per-hash pod-name lists)`` with the
        same early-stop semantics as ``lookup`` (``processed < len(hashes)``
        marks a present-but-empty key at that position), or ``None`` when
        the loaded library predates the read-side symbol (caller falls back
        to the promoting path)."""
        if not self._idx.has_lookup_ro:
            return None
        if not hashes:
            return 0, []
        mid = self._model_id(model_name, create=False)
        if mid is None:
            return len(hashes), [[] for _ in hashes]
        processed, per_key = self._idx.lookup_ro(
            mid, list(hashes), self._filter_ids(pod_filter)
        )
        names = self._snap.pod_names
        return processed, [
            [names[pid] for pid, _tier in pods] for pods in per_key
        ]

    def add_hashes(
        self,
        model_name: str,
        hashes: Sequence[int],
        entries: Sequence[PodEntry],
    ) -> None:
        """Key-free write path from raw chain hashes: one intern pass and
        one native call for the whole run. The sharded event plane's apply
        workers use this so a store burst costs no ``Key`` allocations."""
        if not hashes or not entries:
            raise ValueError("no keys or entries provided for adding to index")
        pods, tiers = [], []
        for e in entries:
            pods.append(self._pod_id(e.pod_identifier, create=True))
            tiers.append(_TIER_TO_ID[e.device_tier])
        mid = self._model_id(model_name, create=True)
        self._idx.add(mid, list(hashes), pods, tiers)

    def add(self, keys: Sequence[Key], entries: Sequence[PodEntry]) -> None:
        if not keys or not entries:
            raise ValueError("no keys or entries provided for adding to index")
        pods, tiers = [], []
        for e in entries:
            pods.append(self._pod_id(e.pod_identifier, create=True))
            tiers.append(_TIER_TO_ID[e.device_tier])
        i, n = 0, len(keys)
        while i < n:  # one native call per consecutive same-model run
            j = i
            model = keys[i].model_name
            while j < n and keys[j].model_name == model:
                j += 1
            mid = self._model_id(model, create=True)
            self._idx.add(mid, [k.chunk_hash for k in keys[i:j]], pods, tiers)
            i = j

    def evict(self, key: Key, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        mid = self._model_id(key.model_name, create=False)
        if mid is None:
            return
        pod_ids = self._snap.pod_ids
        pods, tiers = [], []
        for e in entries:
            pid = pod_ids.get(e.pod_identifier)
            if pid is None:
                continue
            pods.append(pid)
            tiers.append(_TIER_TO_ID[e.device_tier])
        if pods:
            self._idx.evict(mid, key.chunk_hash, pods, tiers)

    def _distinct_pod_ids(self) -> Optional[list[int]]:
        """Exact distinct pod ids holding >= 1 entry via the C occupancy
        walk; None on an older library. Exactness matters once shards
        share an intern table: the ever-interned count is GROUP-wide, so
        per-shard gauges fed from it would read identically flat."""
        snap = self._snap
        return self._idx.distinct_pods(max(len(snap.pod_names), 1))

    def size_info(self) -> dict:
        ids = self._distinct_pod_ids()
        if ids is None:
            # Library predates the occupancy walk: pods ever interned this
            # process (a documented superset — see docs/observability.md).
            return {
                "blocks": int(self._idx.size()),
                "pods": len(self._snap.pod_names),
            }
        return {"blocks": int(self._idx.size()), "pods": len(ids)}

    def pod_names(self) -> Optional[Sequence[str]]:
        """Distinct pods currently holding >= 1 entry (exact via the C
        occupancy walk; falls back to the ever-interned superset on an old
        library). Lets the sharded facade union pods across shards."""
        ids = self._distinct_pod_ids()
        names = self._snap.pod_names
        if ids is None:
            return names
        return sorted(names[pid] for pid in ids if pid < len(names))

    def evict_pod(self, pod_identifier: str) -> int:
        pid = self._pod_id(pod_identifier, create=False)
        if pid is None:  # never interned = never added: nothing to sweep
            return 0
        removed = int(self._idx.evict_pod(pid))
        if removed:
            log.debug("swept pod from index", pod=pod_identifier, entries=removed)
        return removed

    def score_longest_prefix(
        self,
        keys: Sequence[Key],
        pod_filter: Optional[set[str]] = None,
    ) -> Optional[dict[str, int]]:
        """Fused lookup+score in one native call (LongestPrefixScorer
        semantics). Returns None when keys span models — the caller then
        falls back to the two-step path."""
        out = self.score_longest_prefix_with_hits(keys, pod_filter)
        return None if out is None else out[0]

    def score_longest_prefix_with_hits(
        self,
        keys: Sequence[Key],
        pod_filter: Optional[set[str]] = None,
    ) -> Optional[tuple[dict[str, int], int]]:
        if not keys:
            return {}, 0
        model = keys[0].model_name
        if any(k.model_name != model for k in keys[1:]):
            return None
        return self.score_hashes_with_hits(
            model, [k.chunk_hash for k in keys], pod_filter
        )

    def score_hashes(
        self,
        model_name: str,
        hashes: Sequence[int],
        pod_filter: Optional[set[str]] = None,
    ) -> dict[str, int]:
        """Fused scoring from raw chain hashes — the zero-object hot path
        (no Key allocation between the hash kernel and the index)."""
        scores, _hits = self.score_hashes_with_hits(model_name, hashes, pod_filter)
        return scores

    def score_hashes_with_hits(
        self,
        model_name: str,
        hashes: Sequence[int],
        pod_filter: Optional[set[str]] = None,
    ) -> tuple[dict[str, int], int]:
        """Like ``score_hashes`` but also returns the lookup-hit count (keys
        with a filter-surviving pod) so the instrumented decorator can report
        metrics identical to the two-step path."""
        if not hashes:
            return {}, 0
        mid = self._model_id(model_name, create=False)
        if mid is None:
            return {}, 0
        scored, hits = self._idx.score(
            mid, hashes, self._filter_ids(pod_filter)
        )
        names = self._snap.pod_names
        return {names[pid]: int(s) for pid, s in scored}, hits

    def __len__(self) -> int:
        return self._idx.size()
