"""Sharded control plane: chain-hash-partitioned index + scorer shards.

The scoring service and its block index are the fleet's last singleton —
at millions of users the KV-event plane and the score RPC saturate long
before the TPU pods do. This module partitions the block index by chain
hash (consistent hashing over the uint64 chained prefix hash) across N
scorer shards, each owning a disjoint key range, behind two facades that
keep every existing caller unchanged:

- ``ShardedIndex`` implements the ``Index`` ABC over N backend instances
  (any of the five conformance-tested backends), so ``KVCacheIndexer``,
  ``FleetHealth``'s sweeper, and the instrumented decorator compose as if
  it were one index. Writes route point-wise to the owner shard; score
  reads fan out per-shard subsequences and merge the per-position pod
  sets at the facade with ``LongestPrefixScorer`` semantics.
- ``ShardedEventsPool`` mirrors ``KVEventsPool``'s exterior contract
  (``start``/``shutdown``/``drain``/``add_task``/
  ``rejected_after_shutdown``) but splits each decoded batch into
  per-shard apply tasks: one dedicated worker per shard applies only its
  own range to its own sub-index, so event ingest never takes a
  cross-shard lock and the ingest path scales with shard count
  independently of the read path.

Semantics notes (the honest deltas from a single index, all invisible to
the scorer's output):

- ``Index.lookup``'s present-but-empty early stop applies within each
  shard's subsequence. Cross-shard, a position after the break on
  another shard may still be reported; ``LongestPrefixScorer`` treats
  the broken position as a miss either way, so pod scores are identical
  to the single-index result (pinned by the equivalence tests).
- A ring resize strands previously-stored keys on their old shard; the
  index is a locality *cache*, so stale placements age out via LRU,
  events, and resync rather than being migrated. Events caught
  mid-resize are forwarded once to the current owner (never dropped),
  counted by ``kvcache_shard_misroute_total`` and rate-limit WARNed.
"""

from __future__ import annotations

import bisect
import queue
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..utils import RateLimitedWarn, get_logger
from .kvblock import DeviceTier, Index, Key, PodEntry, tier_for_medium
from .kvevents.events import (
    AllBlocksCleared,
    BadBlock,
    BlockRemoved,
    BlockStored,
    Heartbeat,
    IndexSnapshot,
    PodDrained,
    PrefillComplete,
    RequestAudit,
    decode_event_batch,
)
from .kvevents.pool import DEFAULT_CONCURRENCY, Message, fnv1a_32
from .metrics import collector

log = get_logger("kvcache.sharding")
_warn = RateLimitedWarn(log)

#: default virtual nodes per shard on the ring — enough that per-shard load
#: imbalance stays in the few-percent range and a resize moves ~1/N of keys
DEFAULT_VNODES = 64


def _mix64(x: int) -> int:
    """splitmix64 finalizer: uniform ring points from structured seeds."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


#: ownership is materialised at this bucket granularity (2^12 arcs): the
#: ingest hot loop resolves an owner with one shift + one list index
#: instead of a bisect per hash
RING_TABLE_BITS = 12


class HashRing:
    """Consistent-hash ring over the uint64 chain-hash space.

    Each shard contributes ``vnodes`` deterministic points; ownership is
    materialised into a dense 2^12-bucket table (each bucket owned by the
    first vnode point clockwise from its start), so the hot-loop owner
    resolution is one shift + one index. The bucket table IS the
    partition: deterministic across processes (no salts, no randomness),
    so every dispatcher, worker, and test derives the identical split,
    and a resize still moves only ~1/N of buckets (the consistent-hashing
    property, at bucket granularity). Immutable once built — a resize is
    a NEW ring swapped in by the owner (``ShardedIndex.set_ring``), which
    is what makes a stale-ring misroute observable and testable.
    """

    def __init__(self, n_shards: int, vnodes: int = DEFAULT_VNODES):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.n_shards = n_shards
        self.vnodes = vnodes
        points: list[tuple[int, int]] = []
        for shard in range(n_shards):
            for v in range(vnodes):
                points.append((_mix64((shard << 20) | v), shard))
        points.sort()
        pts = [p for p, _ in points]
        owners = [s for _, s in points]
        shift = 64 - RING_TABLE_BITS
        table = []
        for b in range(1 << RING_TABLE_BITS):
            i = bisect.bisect_right(pts, b << shift)
            table.append(owners[i] if i < len(pts) else owners[0])
        self._table = table
        self._shift = shift

    def owner(self, chunk_hash: int) -> int:
        """Shard owning ``chunk_hash`` (uint64; chain hashes are already
        uniform, so they land on the ring directly)."""
        return self._table[(chunk_hash & 0xFFFFFFFFFFFFFFFF) >> self._shift]

    def spread(self, hashes: Sequence[int]) -> dict[int, int]:
        """Owner histogram for a hash sample (balance diagnostics)."""
        out: dict[int, int] = {}
        for h in hashes:
            s = self.owner(h)
            out[s] = out.get(s, 0) + 1
        return out


def _merge_prefix_scores(
    positions_pods: Sequence[Optional[Sequence[str]]],
) -> dict[str, int]:
    """``LongestPrefixScorer`` semantics over per-position pod lists (None
    or empty = miss at that position): pods at position 0 seed the active
    set with score 1, each later position intersects and increments the
    survivors."""
    scores: dict[str, int] = {}
    if not positions_pods:
        return scores
    first = positions_pods[0] or []
    active = set(first)
    for pod in first:
        scores[pod] = 1
    for pods in positions_pods[1:]:
        if not active:
            break
        active &= set(pods or [])
        for pod in active:
            scores[pod] += 1
    return scores


class ShardedIndex(Index):
    """``Index`` facade over N chain-hash-partitioned backend shards."""

    def __init__(
        self,
        shards: Sequence[Index],
        ring: Optional[HashRing] = None,
        vnodes: int = DEFAULT_VNODES,
    ):
        if not shards:
            raise ValueError("ShardedIndex needs at least one shard")
        self.shards: list[Index] = list(shards)
        self.ring = ring if ring is not None else HashRing(len(self.shards), vnodes)
        if self.ring.n_shards != len(self.shards):
            raise ValueError(
                f"ring covers {self.ring.n_shards} shards, got {len(self.shards)}"
            )
        self._refresh_native_fan()

    def _refresh_native_fan(self) -> None:
        """Detect the one-C-call read fan: every shard a NativeMemoryIndex
        sharing ONE intern store (``NativeMemoryIndex.shard_group``), with
        a library new enough for ``lruidx_score_sharded``. Then a score
        fan-out is a single native call that shared-locks every shard
        inside C — one GIL release round trip, no Python lock, concurrent
        with applies on all shards. Published as ONE immutable tuple in a
        single attribute store (atomic under the GIL): a read racing
        ``replace_shard`` sees either the whole old fan or the whole new
        state, never a half-cleared one."""
        fan = None
        try:
            from ..native import lruindex as _nl
            from .kvblock.native_memory import NativeMemoryIndex
        except Exception:  # pragma: no cover - import surface
            self._fan = None
            return
        if (
            _nl.score_sharded_available()
            and all(isinstance(s, NativeMemoryIndex) for s in self.shards)
        ):
            store = self.shards[0]._interns
            if all(s._interns is store for s in self.shards):
                fan = (store, [s._idx for s in self.shards])
        self._fan = fan

    @property
    def _fan_lrus(self):
        """Test/diagnostic view of the fused-fan state (None = merge path)."""
        fan = self._fan
        return None if fan is None else fan[1]

    # -- partition management ------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def owner(self, chunk_hash: int) -> int:
        return self.ring.owner(chunk_hash)

    def set_ring(self, ring: HashRing) -> None:
        """Swap the partition (resize choreography). Keys stored under the
        old ring stay on their old shard until events/LRU/resync age them
        out — the index is a cache, not a source of truth — and in-flight
        events dispatched under the old ring are forwarded once by the
        apply-side owner check."""
        if ring.n_shards != len(self.shards):
            raise ValueError(
                f"ring covers {ring.n_shards} shards, have {len(self.shards)}"
            )
        self.ring = ring

    def replace_shard(self, shard_id: int, new_index: Index) -> Index:
        """Swap in a fresh backend for one shard (replica restart / chaos).
        Returns the old backend. Sibling shards are untouched; the lost
        range repairs via the next resync snapshots."""
        old = self.shards[shard_id]
        self.shards[shard_id] = new_index
        self._refresh_native_fan()
        return old

    def _group(self, keys: Sequence[Key]) -> dict[int, list[Key]]:
        groups: dict[int, list[Key]] = {}
        for k in keys:
            groups.setdefault(self.ring.owner(k.chunk_hash), []).append(k)
        return groups

    # -- Index contract ------------------------------------------------------
    def lookup(
        self, keys: Sequence[Key], pod_filter: Optional[set[str]] = None
    ) -> dict[Key, list[str]]:
        if not keys:
            raise ValueError("no keys provided for lookup")
        groups = self._group(keys)
        if len(groups) == 1:
            ((sid, sub),) = groups.items()
            return self.shards[sid].lookup(sub, pod_filter)
        out: dict[Key, list[str]] = {}
        for sid, sub in groups.items():
            out.update(self.shards[sid].lookup(sub, pod_filter))
        return out

    def add(self, keys: Sequence[Key], entries: Sequence[PodEntry]) -> None:
        if not keys or not entries:
            raise ValueError("no keys or entries provided for adding to index")
        for sid, sub in self._group(keys).items():
            self.shards[sid].add(sub, entries)

    def evict(self, key: Key, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        self.shards[self.ring.owner(key.chunk_hash)].evict(key, entries)

    def evict_pod(self, pod_identifier: str) -> int:
        return sum(s.evict_pod(pod_identifier) for s in self.shards)

    def per_shard_size_info(self) -> list[Optional[dict]]:
        out = []
        for s in self.shards:
            try:
                out.append(s.size_info())
            except Exception:
                log.exception("shard size_info failed")
                out.append(None)
        return out

    def size_info(self) -> Optional[dict]:
        """Aggregate occupancy: blocks sum exactly (key ranges are
        disjoint); pods union via ``pod_names()`` when every shard can
        enumerate, else the max shard count (a pod usually holds keys on
        every shard, so max is the tight lower bound)."""
        per = self.per_shard_size_info()
        if any(p is None for p in per):
            return None
        names: Optional[set[str]] = set()
        for s in self.shards:
            shard_names = getattr(s, "pod_names", lambda: None)()
            if shard_names is None:
                names = None
                break
            names.update(shard_names)
        return {
            "blocks": sum(p["blocks"] for p in per),
            "pods": (
                len(names)
                if names is not None
                else max((p["pods"] for p in per), default=0)
            ),
        }

    def pod_names(self) -> Optional[Sequence[str]]:
        names: set[str] = set()
        for s in self.shards:
            shard_names = getattr(s, "pod_names", lambda: None)()
            if shard_names is None:
                return None
            names.update(shard_names)
        return sorted(names)

    # -- fan-out read path ---------------------------------------------------
    def score_hashes_with_hits(
        self,
        model_name: str,
        hashes: Sequence[int],
        pod_filter: Optional[set[str]] = None,
    ) -> tuple[dict[str, int], int]:
        """Fused read fan-out: each shard resolves its subsequence of the
        chain (via its lock-free ``lookup_hashes_ro`` read path when the
        backend offers one), and the facade merges per-position pod sets
        into the longest-prefix scoreboard. ``hits`` counts positions with
        a filter-surviving pod, matching the two-step path's metric."""
        if not hashes:
            return {}, 0
        fan = self._fan
        if fan is not None:
            # One C call across every shard: shared-locks inside, no LRU
            # promotion, no Python lock, one GIL round trip.
            from ..native import lruindex as _nl

            store, lrus = fan
            mid = store.snap.model_ids.get(model_name)
            if mid is None:
                return {}, 0
            owner = self.ring.owner
            filter_ids = self.shards[0]._filter_ids(pod_filter)
            scored, hits = _nl.score_sharded(
                lrus,
                mid,
                list(hashes),
                [owner(h) for h in hashes],
                filter_ids,
            )
            # Resolve names from the snapshot AFTER the call: a pod
            # interned (and C-applied) while the GIL was released can
            # appear in the output, and only the post-call snapshot is
            # guaranteed to cover it (the store only grows).
            names = store.snap.pod_names
            return {names[pid]: int(s) for pid, s in scored}, hits
        positions: list[Optional[list[str]]] = [None] * len(hashes)
        groups: dict[int, tuple[list[int], list[int]]] = {}
        for pos, h in enumerate(hashes):
            sub = groups.setdefault(self.ring.owner(h), ([], []))
            sub[0].append(pos)
            sub[1].append(h)
        if len(groups) == 1:
            # Whole chain on one shard: its own fused score (one native
            # call) beats the merge path outright.
            ((sid, _),) = groups.items()
            fused = getattr(self.shards[sid], "score_hashes_with_hits", None)
            if fused is not None:
                return fused(model_name, hashes, pod_filter)
        for sid, (sub_pos, sub_hashes) in groups.items():
            shard = self.shards[sid]
            resolved: Optional[list[Optional[list[str]]]] = None
            ro = getattr(shard, "lookup_hashes_ro", None)
            if ro is not None:
                out = ro(model_name, sub_hashes, pod_filter)
                if out is not None:
                    processed, per_hash = out
                    resolved = list(per_hash) + [None] * (
                        len(sub_hashes) - processed
                    )
            if resolved is None:
                keys = [Key(model_name, h) for h in sub_hashes]
                found = shard.lookup(keys, pod_filter)
                resolved = [found.get(k) for k in keys]
            for pos, pods in zip(sub_pos, resolved):
                positions[pos] = list(pods) if pods else None
        hits = sum(1 for pods in positions if pods)
        return _merge_prefix_scores(positions), hits

    def score_hashes(
        self,
        model_name: str,
        hashes: Sequence[int],
        pod_filter: Optional[set[str]] = None,
    ) -> dict[str, int]:
        scores, _hits = self.score_hashes_with_hits(model_name, hashes, pod_filter)
        return scores

    def score_longest_prefix_with_hits(
        self,
        keys: Sequence[Key],
        pod_filter: Optional[set[str]] = None,
    ) -> Optional[tuple[dict[str, int], int]]:
        if not keys:
            return {}, 0
        model = keys[0].model_name
        if any(k.model_name != model for k in keys[1:]):
            return None  # mixed models: caller falls back to two-step
        return self.score_hashes_with_hits(
            model, [k.chunk_hash for k in keys], pod_filter
        )

    def score_longest_prefix(
        self,
        keys: Sequence[Key],
        pod_filter: Optional[set[str]] = None,
    ) -> Optional[dict[str, int]]:
        out = self.score_longest_prefix_with_hits(keys, pod_filter)
        return None if out is None else out[0]


# ---------------------------------------------------------------------------
# Event-ingest plane
# ---------------------------------------------------------------------------


@dataclass
class _ShardTask:
    """One shard's slice of one decoded event batch."""

    shard: int
    pod: str
    model: str
    seq: int
    ts: float
    #: event-type names contributing ops to this shard (staleness labels)
    tags: list[str]
    #: ("add", hashes, entries) | ("evict", hash, entries) |
    #: ("evict_pod",) | ("resync", {medium: [hashes]}) — hashes stay raw
    #: uint64 all the way to the backend (no Key objects on the hot path)
    ops: list[tuple] = field(default_factory=list)
    #: a stale-ring misroute is forwarded at most once, then applied where
    #: it lands — late locality beats dropped locality
    forwarded: bool = False
    #: the ring this task was split under. The apply side re-checks key
    #: ownership ONLY when the live ring is a different object (a resize
    #: landed between dispatch and apply) — the steady-state hot path
    #: pays zero per-key owner checks.
    ring: Optional[HashRing] = None


@dataclass
class ShardedEventsPoolConfig:
    #: decode/dispatch workers, sharded by pod id (per-pod order holds)
    dispatchers: int = DEFAULT_CONCURRENCY


class ShardedEventsPool:
    """Chain-hash-sharded event ingestion: decode once, apply per shard.

    Mirrors ``KVEventsPool``'s exterior contract so ``ZMQSubscriber`` and
    ``ScoringService`` compose unchanged. Internals differ: dispatcher
    workers (sharded by pod id, preserving per-pod decode order) split
    each batch into per-shard ops; one dedicated worker per index shard
    applies its own range to its own sub-index. Per-(pod, shard) FIFO
    ordering holds end to end, and no apply ever crosses a shard
    boundary — the ingest path scales with shards, not with one lock.

    ``staleness`` is an optional list of per-shard trackers (one per index
    shard): each shard's tracker observes dispatch→apply lag and seq
    high-waters for ITS lane, which is exactly how a drowning shard shows
    up. ``health``/``audit`` receive pod-level observations once per
    message, like the single pool.
    """

    def __init__(
        self,
        index: ShardedIndex,
        config: Optional[ShardedEventsPoolConfig] = None,
        health=None,
        *,
        staleness: Optional[Sequence] = None,
        audit=None,
        lifecycle=None,
        on_bad_block=None,
        instrument: bool = False,
    ):
        """``instrument=True`` keeps the admission/eviction counters in
        step with the single plane, where the pool applies through the
        ``InstrumentedIndex`` decorator: here the shard workers write to
        the raw sub-indexes, so the plane accounts its own applies.
        ``on_bad_block``: same replica-purge hook as the single pool's."""
        self.config = config or ShardedEventsPoolConfig()
        if self.config.dispatchers < 1:
            raise ValueError("dispatchers must be >= 1")
        self.index = index
        self.health = health
        self.audit = audit
        self.on_bad_block = on_bad_block
        #: OBS_LIFECYCLE ledger (obs/lifecycle.py): fed at the decode
        #: stage (per-pod dispatcher order, same vantage as health), so
        #: the sharded plane's block tier story matches the single pool's.
        self.lifecycle = lifecycle
        self.instrument = instrument
        self.staleness = list(staleness) if staleness else None
        if self.staleness is not None and len(self.staleness) != index.n_shards:
            raise ValueError("need one staleness tracker per shard")
        self._mu = threading.Lock()
        self.rejected_after_shutdown = 0  # guarded_by: _mu
        self.misroutes = 0  # guarded_by: _mu
        self._misroutes_by_shard: dict[int, int] = {}  # guarded_by: _mu
        #: per-pod seq high-waters at the ADMISSION edge vs the decode
        #: stage: their gap is backlog sitting in the dispatcher queues,
        #: which no per-shard lane tracker can see (a lane's received
        #: high-water only advances at dispatch).
        self._admitted: dict[str, int] = {}  # guarded_by: _mu
        self._dispatched: dict[str, int] = {}  # guarded_by: _mu
        #: immutable after construction; workers index them lock-free
        self._dispatch_queues: list["queue.Queue[Optional[Message]]"] = [
            queue.Queue() for _ in range(self.config.dispatchers)
        ]
        self._shard_queues: list["queue.Queue[Optional[_ShardTask]]"] = [
            queue.Queue() for _ in range(index.n_shards)
        ]
        self._threads: list[threading.Thread] = []  # guarded_by: _mu
        self._running = False  # guarded_by: _mu
        self._started = False  # guarded_by: _mu

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        with self._mu:
            if self._running:
                return
            self._running = True
            self._started = True
            for i in range(self.config.dispatchers):
                t = threading.Thread(
                    target=self._dispatcher,
                    args=(i,),
                    name=f"kvshard-dispatch-{i}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)
            for i in range(self.index.n_shards):
                t = threading.Thread(
                    target=self._shard_worker,
                    args=(i,),
                    name=f"kvshard-apply-{i}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)

    def shutdown(self) -> None:
        """Idempotent. Two-stage drain ordering: dispatcher pills queue
        BEHIND accepted messages, so every accepted message is decoded and
        split before dispatchers exit; shard pills go in only after the
        dispatchers joined, so every split op is applied before the shard
        workers exit."""
        with self._mu:
            if not self._running:
                return
            self._running = False
            threads, self._threads = self._threads, []
        dispatchers = [t for t in threads if t.name.startswith("kvshard-dispatch")]
        workers = [t for t in threads if t.name.startswith("kvshard-apply")]
        for q in self._dispatch_queues:
            q.put(None)
        for t in dispatchers:
            t.join(timeout=5)
        for q in self._shard_queues:
            q.put(None)
        for t in workers:
            t.join(timeout=5)

    def drain(self, timeout: float = 5.0) -> bool:
        """Block until all queued *and in-flight* work (both stages) has
        been applied to the shard indexes."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(
                q.unfinished_tasks == 0
                for q in (*self._dispatch_queues, *self._shard_queues)
            ):
                return True
            time.sleep(0.002)
        return False

    # -- ingestion ----------------------------------------------------------
    def add_task(self, msg: Message) -> None:
        """Same admission contract as ``KVEventsPool.add_task``: sharded by
        pod id onto dispatcher lanes; tasks offered after shutdown are
        rejected (counted), never parked behind a pill."""
        lane = fnv1a_32(msg.pod_identifier.encode("utf-8")) % self.config.dispatchers
        with self._mu:
            if self._started and not self._running:
                self.rejected_after_shutdown += 1
            else:
                prev = self._admitted.get(msg.pod_identifier)
                if prev is None:
                    # Seed the dispatched high-water one below the first
                    # admitted seq so a backlog pending from the very
                    # first message reads as behind, not as zero.
                    self._dispatched.setdefault(
                        msg.pod_identifier, msg.seq - 1
                    )
                if prev is None or msg.seq > prev:
                    self._admitted[msg.pod_identifier] = msg.seq
                self._dispatch_queues[lane].put(msg)
                return
        log.warning("event after pool shutdown; dropping", pod=msg.pod_identifier)

    def _dispatcher(self, lane: int) -> None:
        q = self._dispatch_queues[lane]
        while True:
            msg = q.get()
            if msg is None:
                q.task_done()
                return
            try:
                self._dispatch(msg)
                with self._mu:
                    prev = self._dispatched.get(msg.pod_identifier)
                    if prev is None or msg.seq > prev:
                        self._dispatched[msg.pod_identifier] = msg.seq
            except Exception:
                # Any failure on one message must not kill the lane: a dead
                # dispatcher silently stops splitting its pods' events.
                _warn.warning(
                    f"dispatch-{lane}",
                    "failed to dispatch event message; dropping",
                    exc_info=True,
                    pod=msg.pod_identifier,
                )
            finally:
                q.task_done()

    def _dispatch(self, msg: Message) -> None:
        batch = decode_event_batch(msg.payload)
        if batch is None:
            log.debug("failed to unmarshal event batch, dropping message", topic=msg.topic)
            return
        if self.health is not None:
            self.health.observe_message(msg.pod_identifier, msg.model_name, msg.seq)

        ring = self.index.ring
        tasks: dict[int, _ShardTask] = {}

        def task_for(shard: int) -> _ShardTask:
            t = tasks.get(shard)
            if t is None:
                t = _ShardTask(
                    shard=shard,
                    pod=msg.pod_identifier,
                    model=msg.model_name,
                    seq=msg.seq,
                    ts=batch.ts,
                    tags=[],
                    ring=ring,
                )
                tasks[shard] = t
            return t

        #: consecutive BlockStored events coalesce into ONE per-(shard,
        #: tier) hash run — one apply op (one native call) per shard for a
        #: whole store burst, instead of one per event. Any other event
        #: type flushes first so per-hash ordering within the batch holds.
        add_runs: dict[DeviceTier, dict[int, list[int]]] = {}

        def flush_adds() -> None:
            for tier, by_shard in add_runs.items():
                entries = [PodEntry(msg.pod_identifier, tier)]
                for shard, hs in by_shard.items():
                    task_for(shard).ops.append(("add", hs, entries))
            add_runs.clear()

        for ev in batch.events:
            if isinstance(ev, BlockStored):
                by_shard = add_runs.setdefault(tier_for_medium(ev.medium), {})
                touched: set[int] = set()
                for h in ev.block_hashes:
                    shard = ring.owner(h)
                    by_shard.setdefault(shard, []).append(h)
                    touched.add(shard)
                for shard in touched:
                    task_for(shard).tags.append("BlockStored")
                if self.lifecycle is not None:
                    self.lifecycle.observe_stored(
                        msg.pod_identifier, ev.block_hashes, ev.medium
                    )
            elif isinstance(ev, BlockRemoved):
                flush_adds()
                if ev.medium is None:
                    entries = [PodEntry(msg.pod_identifier, t) for t in DeviceTier]
                else:
                    entries = [
                        PodEntry(msg.pod_identifier, tier_for_medium(ev.medium))
                    ]
                touched: set[int] = set()
                for h in ev.block_hashes:
                    shard = ring.owner(h)
                    task_for(shard).ops.append(("evict", h, entries))
                    touched.add(shard)
                for shard in touched:
                    tasks[shard].tags.append("BlockRemoved")
                if self.lifecycle is not None:
                    self.lifecycle.observe_removed(
                        msg.pod_identifier, ev.block_hashes, ev.medium
                    )
            elif isinstance(ev, BadBlock):
                # Fleet revocation, split by range like BlockRemoved —
                # point evictions on each hash's owner shard, keyed to
                # the HOLDER (``ev.pod`` when the detector revoked a
                # peer's copy, else the publisher).
                flush_adds()
                holder = ev.pod or msg.pod_identifier
                if ev.medium is None:
                    entries = [PodEntry(holder, t) for t in DeviceTier]
                else:
                    entries = [PodEntry(holder, tier_for_medium(ev.medium))]
                touched: set[int] = set()
                for h in ev.block_hashes:
                    shard = ring.owner(h)
                    task_for(shard).ops.append(("evict", h, entries))
                    touched.add(shard)
                for shard in touched:
                    tasks[shard].tags.append("BadBlock")
                if self.audit is not None:
                    self.audit.observe_bad_block(ev.block_hashes)
                if self.health is not None:
                    self.health.observe_bad_block(
                        holder, len(ev.block_hashes)
                    )
                collector.observe_bad_blocks(len(ev.block_hashes))
                if self.on_bad_block is not None:
                    try:
                        self.on_bad_block(holder, ev.block_hashes, ev.medium)
                    except Exception:
                        _warn.warning(
                            "bad-block-purge",
                            "bad-block purge callback failed",
                            exc_info=True,
                            pod=holder,
                        )
            elif isinstance(ev, Heartbeat):
                if self.health is not None:
                    self.health.observe_heartbeat(
                        msg.pod_identifier,
                        ev.dropped_batches,
                        ev.draining,
                        role=ev.role,
                        headroom=ev.headroom,
                    )
            elif isinstance(ev, PrefillComplete):
                if self.health is not None:
                    self.health.observe_prefill_complete(msg.pod_identifier)
            elif isinstance(ev, IndexSnapshot):
                flush_adds()
                # Replace-all-for-pod, split by range: EVERY shard gets a
                # resync op (an empty sub-digest still wipes that shard's
                # stale entries for the pod), each restricted to the hashes
                # it owns — repairing one lost shard re-applies only that
                # shard's slice of the digest on that shard's worker.
                digests: dict[int, dict] = {}
                for shard in range(self.index.n_shards):
                    t = task_for(shard)
                    digests[shard] = {}
                    t.ops.append(("resync", digests[shard]))
                    t.tags.append("IndexSnapshot")
                for medium, hashes in ev.blocks_by_medium.items():
                    for h in hashes:
                        digests[ring.owner(h)].setdefault(medium, []).append(h)
                if self.health is not None:
                    self.health.observe_resync(msg.pod_identifier)
                if self.lifecycle is not None:
                    # Replace-all in the ledger too (single-pool rule).
                    self.lifecycle.observe_pod_gone(
                        msg.pod_identifier, "resync"
                    )
                    for medium, hashes in ev.blocks_by_medium.items():
                        if hashes:
                            self.lifecycle.observe_stored(
                                msg.pod_identifier, hashes, medium
                            )
            elif isinstance(ev, PodDrained):
                flush_adds()
                for shard in range(self.index.n_shards):
                    t = task_for(shard)
                    t.ops.append(("evict_pod",))
                    t.tags.append("PodDrained")
                if self.health is not None:
                    self.health.observe_drained(msg.pod_identifier)
                if self.lifecycle is not None:
                    self.lifecycle.observe_pod_gone(
                        msg.pod_identifier, "drained"
                    )
                log.info("pod drained; evicted from index", pod=msg.pod_identifier)
            elif isinstance(ev, RequestAudit):
                if self.audit is not None:
                    self.audit.record_realized(
                        ev.request_id, msg.pod_identifier, ev.realized_blocks
                    )
            elif isinstance(ev, AllBlocksCleared):
                continue

        flush_adds()
        for shard, t in tasks.items():
            if self.staleness is not None:
                self.staleness[shard].observe_received(t.pod, t.seq)
            self._shard_queues[shard].put(t)

    def _shard_worker(self, shard: int) -> None:
        q = self._shard_queues[shard]
        while True:
            task = q.get()
            if task is None:
                q.task_done()
                return
            try:
                self._apply(shard, task)
            except Exception:
                _warn.warning(
                    f"shard-{shard}",
                    "failed to apply shard task; dropping",
                    exc_info=True,
                    pod=task.pod,
                )
            finally:
                q.task_done()

    def _apply(self, shard: int, task: _ShardTask) -> None:
        ring = self.index.ring
        index = self.index.shards[shard]
        # Steady state: the live ring is the very object the dispatcher
        # split under, so every key is owned here by construction and the
        # per-key re-check is skipped. A resize swaps in a NEW ring object;
        # only tasks split under the old one pay the re-check (and forward).
        recheck = ring is not task.ring and not task.forwarded
        add_hashes = getattr(index, "add_hashes", None)
        stray: dict[int, _ShardTask] = {}
        for op in task.ops:
            kind = op[0]
            try:
                if kind == "add":
                    hashes, entries = op[1], op[2]
                    if recheck:
                        hashes = self._split_stray(
                            shard, ring, hashes, task, stray, entries
                        )
                        if not hashes:
                            continue
                    if add_hashes is not None:
                        add_hashes(task.model, hashes, entries)
                    else:
                        index.add(
                            [Key(task.model, h) for h in hashes], entries
                        )
                    if self.instrument:
                        n = len(hashes) * len(entries)
                        collector.admissions.inc(n)
                        collector.bump("admissions", n)
                elif kind == "evict":
                    h, entries = op[1], op[2]
                    if recheck and ring.owner(h) != shard:
                        self._forward(stray, ring.owner(h), task).ops.append(op)
                        continue
                    index.evict(Key(task.model, h), entries)
                    if self.instrument:
                        collector.evictions.inc(len(entries))
                        collector.bump("evictions", len(entries))
                elif kind == "evict_pod":
                    removed = index.evict_pod(task.pod)
                    if self.instrument and removed:
                        collector.evictions.inc(removed)
                        collector.bump("evictions", removed)
                elif kind == "resync":
                    self._apply_resync(index, task, op[1])
            except Exception:
                _warn.warning(
                    f"apply-{kind}-{shard}",
                    "failed to apply event op to shard index",
                    exc_info=True,
                    pod=task.pod,
                    shard=shard,
                )
        self._flush_stray(shard, stray, task)
        if self.staleness is not None:
            self.staleness[shard].observe_batch(
                task.pod, task.seq, task.ts, task.tags
            )

    def _split_stray(self, shard, ring, hashes, task, stray, entries) -> list[int]:
        """Partition an add's hashes into locally-owned vs stale-ring
        strays (queued for one forward to their current owner)."""
        mine: list[int] = []
        for h in hashes:
            owner = ring.owner(h)
            if owner == shard:
                mine.append(h)
            else:
                self._forward(stray, owner, task).ops.append(("add", [h], entries))
        return mine

    def _forward(
        self, stray: dict[int, _ShardTask], owner: int, task: _ShardTask
    ) -> _ShardTask:
        t = stray.get(owner)
        if t is None:
            t = _ShardTask(
                shard=owner,
                pod=task.pod,
                model=task.model,
                seq=task.seq,
                ts=task.ts,
                tags=list(task.tags),
                forwarded=True,
            )
            stray[owner] = t
        return t

    def _flush_stray(
        self, shard: int, stray: dict[int, _ShardTask], task: _ShardTask
    ) -> None:
        """A stale-ring misroute (resize raced the dispatch) is forwarded
        exactly once to the current owner and WARNed at a bounded rate —
        locality arrives late instead of silently evaporating."""
        if not stray:
            return
        n_ops = sum(len(t.ops) for t in stray.values())
        with self._mu:
            self.misroutes += n_ops
            self._misroutes_by_shard[shard] = (
                self._misroutes_by_shard.get(shard, 0) + n_ops
            )
        collector.observe_shard_misroute(str(shard), n_ops)
        _warn.warning(
            f"misroute-{shard}",
            "stale-ring misroute: forwarding ops to current owner shard",
            pod=task.pod,
            from_shard=shard,
            ops=n_ops,
        )
        for owner, t in stray.items():
            self._shard_queues[owner].put(t)

    @staticmethod
    def _apply_resync(index: Index, task: _ShardTask, digest: dict) -> None:
        """This shard's slice of a replace-all-for-pod snapshot: wipe the
        pod's entries from THIS sub-index, re-add exactly the owned slice
        of the digest (same contract as ``KVEventsPool._apply_snapshot``,
        restricted to one key range)."""
        index.evict_pod(task.pod)
        add_hashes = getattr(index, "add_hashes", None)
        for medium, hashes in digest.items():
            if not hashes:
                continue
            entries = [PodEntry(task.pod, tier_for_medium(medium))]
            if add_hashes is not None:
                add_hashes(task.model, hashes, entries)
            else:
                index.add([Key(task.model, h) for h in hashes], entries)

    # -- read side -----------------------------------------------------------
    def misroute_snapshot(self) -> dict:
        with self._mu:
            return {
                "total": self.misroutes,
                "by_shard": dict(self._misroutes_by_shard),
            }

    def admission_behind(self) -> dict[str, int]:
        """Per pod: batches admitted but not yet decoded/split (the
        dispatcher-queue backlog the per-shard lane trackers cannot see).
        ``MergedStaleness`` folds this into the events-behind view so a
        drowning DECODE stage reads as behind, not as quiet lanes."""
        with self._mu:
            return {
                pod: max(seq - self._dispatched.get(pod, seq), 0)
                for pod, seq in self._admitted.items()
            }


__all__ = [
    "DEFAULT_VNODES",
    "HashRing",
    "ShardedEventsPool",
    "ShardedEventsPoolConfig",
    "ShardedIndex",
]
